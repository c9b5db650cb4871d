"""Minimal PLY reader/writer, binary little-endian + ascii vertices (a copy
of gssr_tpu/dataio/ply.py, which the port may not import).

The gaussian schema written with it matches the 3DGS-ecosystem PLY
layout, so exported gaussians load in gssr_tpu and in CUDA-side tools.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}
_INV_DTYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
               "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY file into {property: column}."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                cur = (tok[1].decode(), int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == b"property":
                if tok[1] == b"list":
                    raise ValueError("list properties unsupported")
                cur[2].append((tok[2].decode(), _PLY_DTYPES[tok[1].decode()]))
            elif tok[0] == b"end_header":
                break
        out = {}
        for name, count, props in elements:
            if fmt == "ascii":
                rows = np.loadtxt(f, dtype=np.float64, max_rows=count, ndmin=2)
                cols = {p: rows[:, i].astype(dt)
                        for i, (p, dt) in enumerate(props)}
            else:
                endian = "<" if "little" in fmt else ">"
                dtype = np.dtype([(p, endian + dt) for p, dt in props])
                data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
                cols = {p: np.ascontiguousarray(data[p]) for p, _ in props}
            if name == "vertex":
                out = cols
        return out


def write_ply(path: str, columns: Dict[str, np.ndarray], ascii: bool = False):
    """Write named columns (all same length) as a binary-LE 'vertex' element."""
    names = list(columns.keys())
    n = len(next(iter(columns.values())))
    arrays = {k: np.asarray(v).reshape(n) for k, v in columns.items()}
    dtype = np.dtype([(k, arrays[k].dtype.str[-2:]) for k in names])
    header = ["ply",
              "format ascii 1.0" if ascii else "format binary_little_endian 1.0",
              f"element vertex {n}"]
    for k in names:
        header.append(f"property {_INV_DTYPES[arrays[k].dtype.str[-2:]]} {k}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if ascii:
            rows = np.stack([arrays[k].astype(np.float64) for k in names], axis=1)
            np.savetxt(f, rows, fmt="%.8g")
        else:
            rec = np.empty(n, dtype=dtype)
            for k in names:
                rec[k] = arrays[k]
            f.write(rec.tobytes())


def write_point_cloud_ply(path: str, points: np.ndarray, colors: np.ndarray,
                          normals: np.ndarray | None = None):
    """Points + uint8 colors (+ normals) — the points3D.ply interchange file."""
    if normals is None:
        normals = np.zeros_like(points)
    cols = {
        "x": points[:, 0].astype(np.float32),
        "y": points[:, 1].astype(np.float32),
        "z": points[:, 2].astype(np.float32),
        "nx": normals[:, 0].astype(np.float32),
        "ny": normals[:, 1].astype(np.float32),
        "nz": normals[:, 2].astype(np.float32),
        "red": colors[:, 0].astype(np.uint8),
        "green": colors[:, 1].astype(np.uint8),
        "blue": colors[:, 2].astype(np.uint8),
    }
    write_ply(path, cols)


def read_point_cloud_ply(path: str):
    cols = read_ply(path)
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float64)
    if "red" in cols:
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1)
        colors = rgb.astype(np.float64) / 255.0
    else:
        colors = np.ones_like(pts) * 0.5
    if "nx" in cols:
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals
