"""Camera model (port of gssr_tpu/cameras/__init__.py).

Matrices use the column-vector convention (p_cam = w2c @ p_world).
`Camera` is host-side numpy; `CameraArrays` is the same camera as float32
tensors on one device, which is what the rasterizer takes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gssr_tpu_torch.utils.graphics import (
    fov_to_focal,
    projection_matrix,
    world_to_view,
)
from gssr_tpu_torch.utils.tracing import span

ZNEAR = 0.01
ZFAR = 100.0


@dataclasses.dataclass
class CameraArrays:
    """A camera as float32 tensors on one device (scalars are 0-d)."""
    w2c: torch.Tensor          # [4,4] world -> camera
    full_proj: torch.Tensor    # [4,4] proj @ w2c
    campos: torch.Tensor       # [3]
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    tan_fovx: torch.Tensor
    tan_fovy: torch.Tensor


@dataclasses.dataclass
class Camera:
    """Host-side camera: COLMAP pose + (optionally) the GT image."""
    uid: int
    colmap_id: int
    image_name: str
    R: np.ndarray            # [3,3] cam-to-world rotation (COLMAP convention)
    T: np.ndarray            # [3] w2c translation
    fovx: float
    fovy: float
    width: int
    height: int
    image: Optional[np.ndarray] = None       # [H,W,3] float32 in [0,1]
    alpha_mask: Optional[np.ndarray] = None  # [H,W] float32 or None
    image_path: str = ""
    trans: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float64))
    scale: float = 1.0
    # PGSR's multi-view neighbours: indices into the train camera list
    near_ids: tuple = ()

    def __post_init__(self):
        self.w2c = world_to_view(self.R, self.T, self.trans, self.scale)
        self.proj = projection_matrix(ZNEAR, ZFAR, self.fovx, self.fovy)
        self.full_proj = (self.proj @ self.w2c).astype(np.float32)
        c2w = np.linalg.inv(self.w2c.astype(np.float64))
        self.campos = c2w[:3, 3].astype(np.float32)
        self.fx = fov_to_focal(self.fovx, self.width)
        self.fy = fov_to_focal(self.fovy, self.height)
        self.cx = 0.5 * self.width
        self.cy = 0.5 * self.height

    @property
    def tan_fovx(self) -> float:
        return float(np.tan(self.fovx * 0.5))

    @property
    def tan_fovy(self) -> float:
        return float(np.tan(self.fovy * 0.5))

    def arrays(self, device) -> CameraArrays:
        def f32(v):
            with span("sync.camera"):
                return torch.as_tensor(np.asarray(v, dtype=np.float32),
                                       device=device)
        return CameraArrays(
            w2c=f32(self.w2c), full_proj=f32(self.full_proj),
            campos=f32(self.campos),
            fx=f32(self.fx), fy=f32(self.fy), cx=f32(self.cx), cy=f32(self.cy),
            tan_fovx=f32(self.tan_fovx), tan_fovy=f32(self.tan_fovy))
