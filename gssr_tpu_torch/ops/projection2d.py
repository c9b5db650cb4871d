"""2DGS (surfel) preprocess: the splat-to-pixel homogeneous transform and its
tile rect (port of gssr_tpu/ops/projection2d.py).

T = rows (Tu, Tv, Tw) of the 3x3 map from splat UV space to homogeneous
pixel coordinates; the camera-space normal with the dual-visible flip; the
dual-conic AABB of the splat at the CUTOFF level (the low-pass centre) and
at the opacity level set (the tile rect). Branch-free masked math over the
fixed-capacity arrays; autograd differentiates it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gssr_tpu_torch.ops.projection import (
    NEAR_CULL,
    TILE,
    opacity_sigma_factor,
    project_points,
    tile_rect,
)
from gssr_tpu_torch.utils.general import quat_to_rotmat
from gssr_tpu_torch.utils.tracing import span

FILTER_SIZE = 0.707106          # sqrt(2)/2 low-pass radius
FILTER_INV_SQUARE = 2.0
CUTOFF = 3.0


class Projected2D(NamedTuple):
    mean2d: torch.Tensor         # [N,2] AABB centre in pixels (low-pass centre)
    Tmat: torch.Tensor           # [N,3,3] rows (Tu, Tv, Tw)
    normal: torch.Tensor         # [N,3] camera-space normal, flipped to face
    depth: torch.Tensor          # [N] view-space z
    radius: torch.Tensor         # [N] int32
    rect: torch.Tensor           # [N,4] int32
    tiles_touched: torch.Tensor  # [N] int32


def _conic_aabb(Tu, Tv, Tw, level, visible):
    """Dual-conic AABB of the {rho3d <= level^2} image: centre (cx, cy)
    and half-extents (hx, hy) in pixels; `level` is [N] or a scalar."""
    if not torch.is_tensor(level):
        with span("sync.conic_level"):
            level = torch.as_tensor(level, dtype=torch.float32,
                                    device=Tw.device)
    lvl2 = torch.broadcast_to(torch.as_tensor(level, dtype=torch.float32,
                                              device=Tw.device) ** 2,
                              Tw.shape[:-1])
    tvec = torch.stack([lvl2, lvl2, -torch.ones_like(lvl2)], dim=-1)
    dval = (tvec * Tw * Tw).sum(-1)
    visible = visible & (dval != 0.0)
    # a sanitised divisor for culled splats: an inf here would give NaN
    # gradients through them even under zero cotangents
    d_safe = torch.where(visible, dval, torch.ones_like(dval))
    f = tvec / d_safe[..., None]
    cx = (f * Tu * Tw).sum(-1)
    cy = (f * Tv * Tw).sum(-1)
    hx = torch.sqrt(torch.clamp(cx * cx - (f * Tu * Tu).sum(-1), min=1e-4))
    hy = torch.sqrt(torch.clamp(cy * cy - (f * Tv * Tv).sum(-1), min=1e-4))
    return cx, cy, hx, hy, visible


def preprocess_2d(means3d, scales2, rotations, camera, width: int,
                  height: int, opacity, scaling_modifier: float = 1.0,
                  active_mask=None) -> Projected2D:
    """width/height are the tile-padded image size; camera is a
    CameraArrays; opacity (activated, [N]) shrinks the rect to the
    alpha >= 1/255 level set."""
    tiles_x, tiles_y = width // TILE, height // TILE
    R = quat_to_rotmat(rotations)                        # [N,3,3]
    L0 = R[..., :, 0] * (scales2[..., 0:1] * scaling_modifier)
    L1 = R[..., :, 1] * (scales2[..., 1:2] * scaling_modifier)
    axis = R[..., :, 2]                                  # world normal axis

    p_view, _ = project_points(means3d, camera.w2c, camera.full_proj)
    depth = p_view[..., 2]
    visible = depth > NEAR_CULL
    if active_mask is not None:
        visible = visible & active_mask

    # pixel-projection rows: [W/2 P0 + (W-1)/2 P3; H/2 P1 + (H-1)/2 P3; P3]
    P = camera.full_proj
    A = torch.stack([0.5 * width * P[0] + 0.5 * (width - 1) * P[3],
                     0.5 * height * P[1] + 0.5 * (height - 1) * P[3],
                     P[3]])                              # [3,4]
    A3, A4 = A[:, :3], A[:, 3]
    cu = L0 @ A3.T
    cv = L1 @ A3.T
    cw = means3d @ A3.T + A4
    Tmat = torch.stack([cu, cv, cw], dim=-1)             # [N,3,3] rows x cols

    # camera-space normal, flipped toward the camera
    n_view = axis @ camera.w2c[:3, :3].T
    cos = -(p_view * n_view).sum(-1)
    visible = visible & (cos != 0.0)
    normal = n_view * torch.sign(cos)[..., None]

    Tu, Tv, Tw = Tmat[..., 0, :], Tmat[..., 1, :], Tmat[..., 2, :]
    # the low-pass centre and the densify radius: the CUTOFF-level box
    cx, cy, hx, hy, visible = _conic_aabb(Tu, Tv, Tw, CUTOFF, visible)
    mean2d = torch.where(visible[..., None], torch.stack([cx, cy], -1),
                         torch.zeros_like(Tu[..., :2]))
    # the alpha >= 1/255 level set: the map is projective, so the level
    # ellipse is recomputed exactly rather than scaled from the CUTOFF one
    s_fac, visible = opacity_sigma_factor(opacity, visible)
    cxL, cyL, rx3, ry3, visible = _conic_aabb(Tu, Tv, Tw, s_fac, visible)
    # union box of the rho3d level ellipse and the low-pass disk
    rlp = s_fac * FILTER_SIZE
    bx0 = torch.minimum(cxL - rx3, cx - rlp)
    bx1 = torch.maximum(cxL + rx3, cx + rlp)
    by0 = torch.minimum(cyL - ry3, cy - rlp)
    by1 = torch.maximum(cyL + ry3, cy + rlp)
    bcen = torch.stack([0.5 * (bx0 + bx1), 0.5 * (by0 + by1)], -1).detach()
    rx = torch.ceil(0.5 * (bx1 - bx0)).detach()
    ry = torch.ceil(0.5 * (by1 - by0)).detach()
    zero = torch.zeros_like(rx)
    radius = torch.where(visible, torch.maximum(rx, ry),
                         zero).to(torch.int32)
    rect = tile_rect(bcen, torch.where(visible, rx, zero), tiles_x, tiles_y,
                     torch.where(visible, ry, zero))
    tiles = (rect[..., 2] - rect[..., 0]) * (rect[..., 3] - rect[..., 1])
    tiles = torch.where(visible, tiles, torch.zeros_like(tiles))
    radius = torch.where(tiles > 0, radius, torch.zeros_like(radius))
    return Projected2D(mean2d=mean2d, Tmat=Tmat, normal=normal, depth=depth,
                       radius=radius, rect=rect, tiles_touched=tiles)
