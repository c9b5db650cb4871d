"""Multi-view pair selection for PGSR from COLMAP covisibility (a copy of
gssr_tpu/dataio/view_selection.py, which the port may not import).

Pairwise scores come from the points two images share, weighted by the
MVSNet triangulation-angle kernel; each camera's neighbours are its
`num_views` best-scoring cameras. As in the reference, a camera scores 0
with itself, so on a scene with fewer covisible cameras than `num_views`
a camera can list itself among its neighbours.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gssr_tpu_torch.dataio import colmap


def view_selection(cam_centers: Sequence[np.ndarray],
                   cam_point_ids: Sequence[np.ndarray],
                   points_xyz: Dict[int, np.ndarray],
                   theta0: float = 5.0, sigma1: float = 1.0,
                   sigma2: float = 10.0,
                   num_views: int = 10) -> List[List[Tuple[int, float]]]:
    n = len(cam_centers)
    all_ids = np.array(sorted(points_xyz.keys()), dtype=np.int64)
    all_xyz = (np.stack([points_xyz[i] for i in all_ids])
               if len(all_ids) else np.zeros((0, 3)))
    id_sets = []
    for ids in cam_point_ids:
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        ids = ids[ids >= 0]
        id_sets.append(ids[np.isin(ids, all_ids, assume_unique=True)])

    score = np.zeros((n, n))
    centers = np.asarray(cam_centers, dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            common = np.intersect1d(id_sets[i], id_sets[j],
                                    assume_unique=True)
            if len(common) == 0:
                continue
            idx = np.searchsorted(all_ids, common)
            p = all_xyz[idx]
            vi = centers[i] - p
            vj = centers[j] - p
            cosang = np.sum(vi * vj, axis=1) / (
                np.linalg.norm(vi, axis=1) * np.linalg.norm(vj, axis=1)
                + 1e-12)
            theta = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
            sigma = np.where(theta <= theta0, sigma1, sigma2)
            s = float(np.sum(np.exp(-(theta - theta0) ** 2
                                    / (2.0 * sigma ** 2))))
            score[i, j] = score[j, i] = s

    out = []
    for i in range(n):
        order = np.argsort(score[i])[::-1]
        out.append([(int(k), float(score[i, k])) for k in order[:num_views]])
    return out


def write_pairs(path: str, view_sel):
    with open(path, "w") as f:
        f.write(f"{len(view_sel)}\n")
        for i, pairs in enumerate(view_sel):
            f.write(f"{i}\n{len(pairs)} ")
            for k, s in pairs:
                f.write(f"{k} {int(s)} ")
            f.write("\n")


def read_pairs(path: str):
    with open(path) as f:
        n = int(f.readline())
        out = []
        for _ in range(n):
            f.readline()
            data = f.readline().split()
            cnt = int(data[0])
            out.append([(int(data[1 + 2 * j]), float(data[2 + 2 * j]))
                        for j in range(cnt)])
    return out


def assign_near_ids(cameras, source_dir: str, sparse_subdir: str = "sparse/0",
                    num_views: int = 5):
    """Set camera.near_ids (indices into the given camera list's order)
    from <source_dir>/pair.txt, or else from COLMAP covisibility, which is
    then written to pair.txt where the directory allows it."""
    pair_path = os.path.join(source_dir, "pair.txt")
    if os.path.exists(pair_path):
        view_sel = read_pairs(pair_path)
    else:
        _, imgs, pts3d = colmap.read_model(
            os.path.join(source_dir, sparse_subdir))
        centers, pid_lists = [], []
        for cam in cameras:
            im = imgs[cam.colmap_id]
            R = im.rotmat()
            t = np.asarray(im.tvec)
            centers.append(-R.T @ t)
            pid_lists.append(im.point3D_ids)
        pts_xyz = {pid: p.xyz for pid, p in pts3d.items()}
        view_sel = view_selection(centers, pid_lists, pts_xyz,
                                  num_views=num_views)
        try:
            write_pairs(pair_path, view_sel)
        except OSError:
            pass      # a read-only scene directory: the cache is optional
    for i, cam in enumerate(cameras):
        if i < len(view_sel):
            cam.near_ids = tuple(k for k, s in view_sel[i])
    return cameras
