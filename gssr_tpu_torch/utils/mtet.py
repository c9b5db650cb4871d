"""Iso-surface extraction via marching tetrahedra (numpy, vectorized; a
copy of gssr_tpu/utils/mtet.py, whose package imports JAX).

Each grid cube splits into 6 tetrahedra; each tetrahedron contributes 0-2
triangles where the signed field crosses the iso level. Table-free (the 16 sign cases are enumerated structurally),
fully vectorized, with optional vertex welding for connectivity.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# cube corner offsets (z, y, x) index order -> corner id 0..7
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=np.int64)                     # (x, y, z) offsets

# 6-tetrahedra decomposition of a cube (corner ids), all sharing diagonal 0-6
_TETS = np.array([
    [0, 5, 1, 6],
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
], dtype=np.int64)

# for each of the 16 sign patterns of a tet (bit i = corner i inside),
# the edges (pairs of local corners) forming 0/1/2 triangles; -1 = unused
_TET_EDGES = {
    0x0: [], 0xF: [],
    0x1: [(0, 1), (0, 2), (0, 3)],
    0x2: [(1, 0), (1, 3), (1, 2)],
    0x4: [(2, 0), (2, 1), (2, 3)],
    0x8: [(3, 0), (3, 2), (3, 1)],
    0xE: [(0, 1), (0, 3), (0, 2)],
    0xD: [(1, 0), (1, 2), (1, 3)],
    0xB: [(2, 0), (2, 3), (2, 1)],
    0x7: [(3, 0), (3, 1), (3, 2)],
    0x3: [(0, 2), (1, 2), (1, 3), (0, 2), (1, 3), (0, 3)],
    0xC: [(2, 0), (3, 1), (2, 1), (2, 0), (3, 0), (3, 1)],
    0x5: [(0, 1), (2, 3), (0, 3), (0, 1), (2, 1), (2, 3)],
    0xA: [(1, 0), (3, 0), (3, 2), (1, 0), (3, 2), (1, 2)],
    0x6: [(1, 0), (2, 0), (2, 3), (1, 0), (2, 3), (1, 3)],
    0x9: [(0, 1), (3, 2), (0, 2), (0, 1), (3, 1), (3, 2)],
}


def marching_tetrahedra(sdf: np.ndarray, level: float = 0.0,
                        spacing: Tuple[float, float, float] = (1, 1, 1),
                        origin=(0.0, 0.0, 0.0), mask: np.ndarray = None,
                        weld: bool = True):
    """Extract the iso-surface of a dense field.

    Args:
      sdf: [X, Y, Z] float field.
      mask: optional [X, Y, Z] bool — cubes whose 8 corners are not all
        valid are skipped (open3d-like behavior for unobserved space).
    Returns (vertices [V,3] float64, faces [F,3] int64).
    """
    f = np.asarray(sdf, np.float64) - level
    X, Y, Z = f.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    cx, cy, cz = np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                             np.arange(Z - 1), indexing="ij")
    base = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)  # [C,3]

    # per-cube corner values [C,8] and validity
    corners = base[:, None, :] + _CORNERS[None]                    # [C,8,3]
    vals = f[corners[..., 0], corners[..., 1], corners[..., 2]]
    if mask is not None:
        valid = mask[corners[..., 0], corners[..., 1], corners[..., 2]]
        cube_ok = valid.all(axis=1)
    else:
        cube_ok = np.ones(len(base), bool)
    # only cubes with a sign change matter
    inside = vals < 0
    active = cube_ok & ~(inside.all(axis=1)) & ~((~inside).all(axis=1))
    base, corners, vals, inside = (base[active], corners[active],
                                   vals[active], inside[active])

    tri_list = []
    for tet in _TETS:
        tv = vals[:, tet]                       # [C,4]
        tc = corners[:, tet]                    # [C,4,3]
        code = ((tv[:, 0] < 0).astype(np.int64)
                | ((tv[:, 1] < 0) << 1)
                | ((tv[:, 2] < 0) << 2)
                | ((tv[:, 3] < 0) << 3))
        for pattern, edges in _TET_EDGES.items():
            if not edges:
                continue
            sel = code == pattern
            if not sel.any():
                continue
            v, c = tv[sel], tc[sel]
            ntri = len(edges) // 3
            for t in range(ntri):
                tri_pts = []
                for (a, b) in edges[3 * t:3 * t + 3]:
                    va, vb = v[:, a], v[:, b]
                    t_interp = va / (va - vb + 1e-30)
                    p = (c[:, a] + t_interp[:, None]
                         * (c[:, b] - c[:, a]).astype(np.float64))
                    tri_pts.append(p)
                tri_list.append(np.stack(tri_pts, axis=1))      # [n,3,3]

    if not tri_list:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tris = np.concatenate(tri_list, axis=0)                      # [T,3,3]
    verts = tris.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)

    if weld:
        # weld identical vertices (grid-edge intersections are exact dups)
        key = np.round(verts * 1e6).astype(np.int64)
        _, idx, inv = np.unique(key, axis=0, return_index=True,
                                return_inverse=True)
        verts = verts[idx]
        faces = inv[faces]
        # drop degenerate faces
        good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                & (faces[:, 0] != faces[:, 2]))
        faces = faces[good]

    sp = np.asarray(spacing, np.float64)
    verts = verts * sp + np.asarray(origin, np.float64)
    return verts, faces


def marching_tetrahedra_blocked(sdf, level=0.0, spacing=(1, 1, 1),
                                origin=(0.0, 0.0, 0.0), mask=None,
                                block: int = 128):
    """Block-wise extraction for large grids (bounds peak memory like the
    reference's 512^3-block marching cubes, mcube_utils.py:17-95)."""
    X, Y, Z = sdf.shape
    sp = np.asarray(spacing, np.float64)
    org = np.asarray(origin, np.float64)
    all_v, all_f = [], []
    off = 0
    for x0 in range(0, X - 1, block):
        for y0 in range(0, Y - 1, block):
            for z0 in range(0, Z - 1, block):
                x1 = min(x0 + block + 1, X)
                y1 = min(y0 + block + 1, Y)
                z1 = min(z0 + block + 1, Z)
                sub = sdf[x0:x1, y0:y1, z0:z1]
                m = mask[x0:x1, y0:y1, z0:z1] if mask is not None else None
                v, f = marching_tetrahedra(sub, level, (1, 1, 1),
                                           (0, 0, 0), m)
                if len(f) == 0:
                    continue
                v = (v + np.array([x0, y0, z0])) * sp + org
                all_v.append(v)
                all_f.append(f + off)
                off += len(v)
    if not all_v:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return np.concatenate(all_v), np.concatenate(all_f)


def keep_largest_clusters(verts: np.ndarray, faces: np.ndarray,
                          num_keep: int = 1, min_faces: int = 0,
                          vert_attrs=None):
    """Connected-component mesh cleanup (mesh_utils.post_process_mesh).
    vert_attrs: optional per-vertex array (e.g. colors) filtered alongside
    the vertices; when given, returns (verts, faces, attrs)."""
    if len(faces) == 0:
        if vert_attrs is not None:
            return verts, faces, vert_attrs
        return verts, faces
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]])
    adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                     shape=(len(verts), len(verts)))
    n_comp, labels = connected_components(adj, directed=False)
    face_label = labels[faces[:, 0]]
    counts = np.bincount(face_label, minlength=n_comp)
    order = np.argsort(counts)[::-1]
    keep_labels = set(order[:num_keep][counts[order[:num_keep]]
                                       >= min_faces].tolist())
    fmask = np.isin(face_label, list(keep_labels))
    faces = faces[fmask]
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    if vert_attrs is not None:
        return verts[used], remap[faces], vert_attrs[used]
    return verts[used], remap[faces]
