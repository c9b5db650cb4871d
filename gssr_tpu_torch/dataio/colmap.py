"""COLMAP sparse-model IO, binary + text read and binary write (a copy of
gssr_tpu/dataio/colmap.py, which the port may not import).

The on-disk formats (cameras/images/points3D .bin/.txt) follow the COLMAP
format spec, so scenes interoperate with the COLMAP ecosystem.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray      # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray       # [N, 2]
    point3D_ids: np.ndarray  # [N]

    def rotmat(self) -> np.ndarray:
        return qvec_to_rotmat(self.qvec)


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    from gssr_tpu_torch.utils.general import rotmat_to_quat
    return rotmat_to_quat(R)


def _read(fid, n, fmt):
    return struct.unpack("<" + fmt, fid.read(n))


# ---------------------------------------------------------------------------
# Binary readers
# ---------------------------------------------------------------------------

def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * np_, "d" * np_))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (npts,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * npts), dtype=np.float64).reshape(npts, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].copy().view(np.int64).reshape(npts)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, ids)
    return images


def read_points3D_binary(path) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            pid = _read(f, 8, "Q")[0]
            xyz = np.array(_read(f, 24, "ddd"))
            rgb = np.array(_read(f, 3, "BBB"), dtype=np.uint8)
            (err,) = _read(f, 8, "d")
            (track_len,) = _read(f, 8, "Q")
            track = np.frombuffer(f.read(8 * track_len), dtype=np.int32).reshape(track_len, 2)
            pts[pid] = ColmapPoint3D(int(pid), xyz, rgb, err,
                                     track[:, 0].copy(), track[:, 1].copy())
    return pts


# ---------------------------------------------------------------------------
# Text readers
# ---------------------------------------------------------------------------

def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            cams[int(e[0])] = ColmapCamera(
                int(e[0]), e[1], int(e[2]), int(e[3]),
                np.array([float(v) for v in e[4:]]))
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        iid = int(e[0])
        qvec = np.array([float(v) for v in e[1:5]])
        tvec = np.array([float(v) for v in e[5:8]])
        cam_id = int(e[8])
        name = e[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([[float(pts[j]), float(pts[j + 1])]
                        for j in range(0, len(pts), 3)]).reshape(-1, 2)
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)],
                       dtype=np.int64)
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, ids)
    return images


def read_points3D_text(path) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            pid = int(e[0])
            xyz = np.array([float(v) for v in e[1:4]])
            rgb = np.array([int(v) for v in e[4:7]], dtype=np.uint8)
            err = float(e[7])
            track = np.array([int(v) for v in e[8:]], dtype=np.int32).reshape(-1, 2)
            pts[pid] = ColmapPoint3D(pid, xyz, rgb, err,
                                     track[:, 0].copy(), track[:, 1].copy())
    return pts


# ---------------------------------------------------------------------------
# Binary writers (needed by the scene partitioner to emit per-tile models)
# ---------------------------------------------------------------------------

def write_cameras_binary(cams: Dict[int, ColmapCamera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))


def write_images_binary(images: Dict[int, ColmapImage], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            data = np.empty((n, 3), dtype=np.float64)
            data[:, :2] = im.xys
            data[:, 2] = im.point3D_ids.astype(np.int64).view(np.float64)
            f.write(data.tobytes())


def write_points3D_binary(pts: Dict[int, ColmapPoint3D], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<ddd", *p.xyz))
            f.write(struct.pack("<BBB", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            n = len(p.image_ids)
            f.write(struct.pack("<Q", n))
            track = np.empty((n, 2), dtype=np.int32)
            track[:, 0] = p.image_ids
            track[:, 1] = p.point2D_idxs
            f.write(track.tobytes())


# ---------------------------------------------------------------------------
# Model-level helpers
# ---------------------------------------------------------------------------

def read_model(sparse_dir: str) -> Tuple[Dict, Dict, Dict]:
    """Read a COLMAP model dir, preferring binary."""
    b = os.path.join(sparse_dir, "cameras.bin")
    if os.path.exists(b):
        return (read_cameras_binary(b),
                read_images_binary(os.path.join(sparse_dir, "images.bin")),
                read_points3D_binary(os.path.join(sparse_dir, "points3D.bin")))
    return (read_cameras_text(os.path.join(sparse_dir, "cameras.txt")),
            read_images_text(os.path.join(sparse_dir, "images.txt")),
            read_points3D_text(os.path.join(sparse_dir, "points3D.txt")))


def write_model(cams, images, pts, sparse_dir: str):
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_binary(cams, os.path.join(sparse_dir, "cameras.bin"))
    write_images_binary(images, os.path.join(sparse_dir, "images.bin"))
    write_points3D_binary(pts, os.path.join(sparse_dir, "points3D.bin"))
