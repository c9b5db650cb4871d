"""TSDF fusion on the device, bounded and contracted-unbounded variants
(port of gssr_tpu/utils/tsdf.py).

A dense voxel grid is projected into each depth map and updated with the
standard truncated-SDF running average; depth, colour and alpha are
sampled bilinearly. The colour volume keeps the reference's channel-major
[3, X, Y, Z] layout, so both packages hold the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gssr_tpu_torch.ops.sampling import bilinear_sample_xy


@dataclasses.dataclass
class TSDFVolume:
    tsdf: torch.Tensor       # [X,Y,Z]
    weight: torch.Tensor     # [X,Y,Z]
    color: torch.Tensor      # [3,X,Y,Z]
    origin: torch.Tensor     # [3]
    voxel_size: float
    sdf_trunc: float


def make_volume(origin, dims, voxel_size: float, sdf_trunc: float,
                device="cpu") -> TSDFVolume:
    X, Y, Z = dims
    return TSDFVolume(
        tsdf=torch.ones((X, Y, Z), device=device),
        weight=torch.zeros((X, Y, Z), device=device),
        color=torch.zeros((3, X, Y, Z), device=device),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        voxel_size=float(voxel_size), sdf_trunc=float(sdf_trunc))


def _voxel_world_coords(vol: TSDFVolume):
    """World coordinates as separate [X,Y,Z] component tensors."""
    X, Y, Z = vol.tsdf.shape
    dev = vol.tsdf.device
    gx, gy, gz = torch.meshgrid(
        *(torch.arange(n, dtype=torch.float32, device=dev)
          for n in (X, Y, Z)), indexing="ij")
    return (gx * vol.voxel_size + vol.origin[0],
            gy * vol.voxel_size + vol.origin[1],
            gz * vol.voxel_size + vol.origin[2])


def integrate(vol: TSDFVolume, depth, rgb, w2c, fx, fy, cx, cy,
              depth_trunc: float = 1e9, alpha=None,
              alpha_thres: float = 0.5) -> TSDFVolume:
    """Integrate one view: depth [H,W], rgb [H,W,3], w2c [4,4] and the
    intrinsics, all on the volume's device. Returns the updated volume."""
    H, W = depth.shape
    wx, wy, wz = _voxel_world_coords(vol)
    R, t = w2c[:3, :3], w2c[:3, 3]
    x_c = wx * R[0, 0] + wy * R[0, 1] + wz * R[0, 2] + t[0]
    y_c = wx * R[1, 0] + wy * R[1, 1] + wz * R[1, 2] + t[1]
    z = wx * R[2, 0] + wy * R[2, 1] + wz * R[2, 2] + t[2]
    zs = torch.where(z != 0, z, 1.0)
    u = x_c * fx / zs + cx
    v = y_c * fy / zs + cy
    in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0)
    d = bilinear_sample_xy(depth, u, v)
    valid_d = (d > 0) & (d < depth_trunc)
    if alpha is not None:
        valid_d = valid_d & (bilinear_sample_xy(alpha, u, v) > alpha_thres)
    sdf = (d - z) / vol.sdf_trunc
    upd = in_img & valid_d & (sdf > -1.0)
    sdf = torch.clamp(sdf, -1.0, 1.0)
    wsum = vol.weight + torch.where(upd, 1.0, 0.0)
    wsafe = torch.clamp(wsum, min=1e-8)
    tsdf = torch.where(upd, (vol.tsdf * vol.weight + sdf) / wsafe, vol.tsdf)
    color = torch.stack([
        torch.where(upd, (vol.color[ch] * vol.weight
                          + bilinear_sample_xy(rgb[..., ch], u, v)) / wsafe,
                    vol.color[ch]) for ch in range(3)])
    return dataclasses.replace(vol, tsdf=tsdf, weight=wsum, color=color)


def extract_mesh(vol: TSDFVolume, level: float = 0.0, num_cluster: int = 0):
    """Marching-tetrahedra surface of the fused volume (on the host).
    Returns (verts, faces, vertex_colors), the colours trilinearly sampled
    from the fused colour volume."""
    from gssr_tpu_torch.utils.mtet import (
        keep_largest_clusters,
        marching_tetrahedra_blocked,
    )
    verts, faces = marching_tetrahedra_blocked(
        vol.tsdf.cpu().numpy(), level=level, spacing=(vol.voxel_size,) * 3,
        origin=vol.origin.cpu().numpy(), mask=(vol.weight > 0).cpu().numpy())
    if num_cluster > 0:
        verts, faces = keep_largest_clusters(verts, faces, num_cluster)
    return verts, faces, sample_volume_colors(vol, verts)


def sample_volume_colors(vol: TSDFVolume, verts: np.ndarray) -> np.ndarray:
    """Trilinear sample of vol.color at world-space vertices (numpy)."""
    if len(verts) == 0:
        return np.zeros((0, 3), np.float32)
    col = np.moveaxis(vol.color.cpu().numpy(), 0, -1)     # [X,Y,Z,3]
    g = (np.asarray(verts) - vol.origin.cpu().numpy()) / vol.voxel_size
    dims = np.asarray(col.shape[:3])
    g = np.clip(g, 0.0, dims - 1.000001)
    g0 = np.floor(g).astype(np.int64)
    f = (g - g0)[..., None]
    g1 = np.minimum(g0 + 1, dims - 1)
    out = np.zeros((len(verts), 3), np.float32)
    for dx, wx in ((0, 1 - f[:, 0]), (1, f[:, 0])):
        for dy, wy in ((0, 1 - f[:, 1]), (1, f[:, 1])):
            for dz, wz in ((0, 1 - f[:, 2]), (1, f[:, 2])):
                ix = g1[:, 0] if dx else g0[:, 0]
                iy = g1[:, 1] if dy else g0[:, 1]
                iz = g1[:, 2] if dz else g0[:, 2]
                out += (wx * wy * wz) * col[ix, iy, iz]
    return np.clip(out, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Unbounded (contracted space) fusion
# ---------------------------------------------------------------------------

def contract(x, center, radius):
    """NeRF++-style contraction of world points into the radius-2 ball."""
    y = (x - center) / radius
    mag = torch.linalg.norm(y, dim=-1, keepdim=True)
    return torch.where(mag > 1.0, (2.0 - 1.0 / mag) * y / mag, y)


def uncontract(y, center, radius):
    mag = torch.linalg.norm(y, dim=-1, keepdim=True)
    x = torch.where(mag > 1.0, y / (mag * (2.0 - mag)), y)
    return x * radius + center
