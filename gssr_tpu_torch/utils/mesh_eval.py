"""Mesh quality metrics: chamfer distance, precision/recall, F1 (a copy of
gssr_tpu/utils/mesh_eval.py, whose package imports JAX).

The Tanks&Temples / DTU protocol: sample dense point clouds on both meshes
(area-weighted), compute bidirectional nearest-neighbour distances, and
report

  precision(tau) = fraction of predicted samples within tau of GT
  recall(tau)    = fraction of GT samples within tau of prediction
  F1(tau)        = harmonic mean of the two
  chamfer        = mean(d_pred->gt) + mean(d_gt->pred)

Used by ``python -m gssr_tpu_torch.extract_mesh --eval-gt <mesh.ply>``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def sample_points_on_mesh(verts: np.ndarray, faces: np.ndarray,
                          n_points: int, seed: int = 0) -> np.ndarray:
    """Uniform (area-weighted) surface samples. verts [V,3] f, faces [F,3] i.

    Degenerate triangles (zero area) get zero sampling probability; a mesh
    whose faces are ALL degenerate falls back to sampling its vertices.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    if len(faces) == 0:
        if len(verts) == 0:
            return np.zeros((0, 3), np.float64)
        idx = rng.integers(0, len(verts), n_points)
        return verts[idx]

    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total = area.sum()
    if total <= 0:
        idx = rng.integers(0, len(verts), n_points)
        return verts[idx]
    tri = rng.choice(len(faces), size=n_points, p=area / total)
    # barycentric: sqrt trick gives uniform density over the triangle
    r1 = np.sqrt(rng.random(n_points))
    r2 = rng.random(n_points)
    w0, w1, w2 = 1.0 - r1, r1 * (1.0 - r2), r1 * r2
    return (w0[:, None] * a[tri] + w1[:, None] * b[tri]
            + w2[:, None] * c[tri])


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """d(p, dst) for each p in src — nearest-neighbour Euclidean distance."""
    from scipy.spatial import cKDTree
    if len(dst) == 0:
        return np.full(len(src), np.inf)
    if len(src) == 0:
        return np.zeros(0)
    tree = cKDTree(np.asarray(dst, np.float64))
    d, _ = tree.query(np.asarray(src, np.float64), k=1, workers=-1)
    return d


def point_cloud_metrics(pred_pts: np.ndarray, gt_pts: np.ndarray,
                        taus: Sequence[float] = (0.05,)) -> Dict:
    """Chamfer + per-tau precision/recall/F1 between two point clouds."""
    d_p2g = nn_distances(pred_pts, gt_pts)   # accuracy side
    d_g2p = nn_distances(gt_pts, pred_pts)   # completeness side
    out: Dict = {
        "chamfer": float(d_p2g.mean() + d_g2p.mean())
        if len(d_p2g) and len(d_g2p) else float("inf"),
        "accuracy_mean": float(d_p2g.mean()) if len(d_p2g) else float("inf"),
        "completeness_mean": float(d_g2p.mean())
        if len(d_g2p) else float("inf"),
    }
    for tau in taus:
        prec = float((d_p2g <= tau).mean()) if len(d_p2g) else 0.0
        rec = float((d_g2p <= tau).mean()) if len(d_g2p) else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
        out[f"precision@{tau:g}"] = prec
        out[f"recall@{tau:g}"] = rec
        out[f"f1@{tau:g}"] = f1
    return out


def mesh_metrics(pred_verts, pred_faces, gt_verts, gt_faces,
                 n_points: int = 200_000,
                 taus: Sequence[float] = (0.05,), seed: int = 0) -> Dict:
    """Sample both meshes and compare. See module docstring for the
    metric definitions (Tanks&Temples-style F-score protocol)."""
    pred = sample_points_on_mesh(pred_verts, pred_faces, n_points, seed)
    gt = sample_points_on_mesh(gt_verts, gt_faces, n_points, seed + 1)
    return point_cloud_metrics(pred, gt, taus)


def eval_mesh_files(pred_path: str, gt_path: str, n_points: int = 200_000,
                    taus: Sequence[float] = (0.05,)) -> Dict:
    """Load two PLY meshes and compute mesh_metrics."""
    from gssr_tpu_torch.utils.mesh_extract import read_mesh_ply
    pv, pf = read_mesh_ply(pred_path)
    gv, gf = read_mesh_ply(gt_path)
    return mesh_metrics(pv, pf, gv, gf, n_points=n_points, taus=taus)
