"""Projection / view matrices (port of gssr_tpu/utils/graphics.py).

Host-side numpy functions with the reference's conventions, so COLMAP
scenes render identically in both packages. The per-pixel depth->normal
chains wait for the 2DGS/PGSR slices.
"""
from __future__ import annotations

import math

import numpy as np


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray, translate=np.zeros(3),
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera (untransposed). R is cam-to-world rotation, t is
    the w2c translation (COLMAP qvec/tvec convention)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """OpenGL-style perspective with z in [0,1]."""
    tan_y = math.tan(fovy / 2.0)
    tan_x = math.tan(fovx / 2.0)
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P
