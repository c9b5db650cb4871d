"""Mesh extraction from a trained scene (port of
gssr_tpu/utils/mesh_extract.py): render every training camera, TSDF-fuse
the per-view depth maps (a bounded voxel grid, or contracted space for
unbounded scenes) on the scene's device, marching tetrahedra on the host,
largest-cluster clean-up.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from gssr_tpu_torch.ops.sampling import bilinear_sample
from gssr_tpu_torch.utils.mtet import marching_tetrahedra_blocked
from gssr_tpu_torch.utils.tsdf import (
    extract_mesh,
    integrate,
    make_volume,
    uncontract,
)


def _depth_of(out):
    for name in ("surf_depth", "plane_depth", "depth_expected"):
        if hasattr(out, name):
            return getattr(out, name)
    raise ValueError("render output has no depth map; mesh extraction "
                     "needs a 2DGS-family method")


def clock(device) -> float:
    """The host clock after the device has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def device_views(cameras, depthmaps, rgbmaps, alphamaps, device):
    """Per captured view: depth, rgb, alpha and the camera's w2c, fx, fy,
    cx, cy, as float32 tensors on the device."""
    f32 = lambda x: torch.as_tensor(                        # noqa: E731
        np.asarray(x, np.float32), device=device)
    for cam, depth, rgb, alpha in zip(cameras, depthmaps, rgbmaps,
                                      alphamaps):
        yield (f32(depth), f32(rgb), f32(alpha), f32(cam.w2c),
               f32(cam.fx), f32(cam.fy), f32(cam.cx), f32(cam.cy))


def bounding_sphere(cameras):
    """The mean camera centre and the least distance of a camera to it."""
    centers = np.stack([c.campos for c in cameras])
    center = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - center, axis=1).min())
    return center, radius


def fuse_bounded(cameras, depthmaps, rgbmaps, alphamaps, device,
                 voxel_size=0.004, sdf_trunc=0.02, depth_trunc=3.0,
                 bound_scale: float = 1.0, alpha_thres: float = 0.5):
    """TSDF-fuse the captured views, in their order, into one cubic volume
    of side depth_trunc * bound_scale (at most 768 voxels a side) centred
    at the mean camera centre. Returns the TSDFVolume."""
    center, _ = bounding_sphere(cameras)
    half = depth_trunc * bound_scale * 0.5
    dims = min(int(np.ceil(2 * half / voxel_size)), 768)
    vol = make_volume(center - half, (dims, dims, dims), voxel_size,
                      sdf_trunc, device=device)
    for depth, rgb, alpha, w2c, fx, fy, cx, cy in device_views(
            cameras, depthmaps, rgbmaps, alphamaps, device):
        vol = integrate(vol, depth, rgb, w2c, fx, fy, cx, cy,
                        depth_trunc=float(depth_trunc), alpha=alpha,
                        alpha_thres=alpha_thres)
    return vol


class GaussianExtractor:
    """Render-all-cameras capture plus TSDF fusion. The captured maps stay
    on the host; each is moved to the device when it is fused.
    `seconds` keeps the time of each stage ("render", "fusion", "mtet")
    on the host clock, after a device synchronise."""

    def __init__(self, scene, state):
        self.scene = scene
        self.state = state
        self.device = scene.device
        self.rgbmaps: List[np.ndarray] = []
        self.depthmaps: List[np.ndarray] = []
        self.alphamaps: List[np.ndarray] = []
        self.cameras = []
        self.seconds = {"render": 0.0, "fusion": 0.0, "mtet": 0.0}

    def reconstruction(self, cameras):
        t0 = clock(self.device)
        self.cameras = list(cameras)
        for cam in self.cameras:
            out = self.scene.eval_render(self.state, cam, step=10 ** 9)
            self.rgbmaps.append(out.image.cpu().numpy())
            self.depthmaps.append(_depth_of(out).cpu().numpy())
            self.alphamaps.append(out.alpha.cpu().numpy())
        self.seconds["render"] += clock(self.device) - t0

    def extract_mesh_bounded(self, voxel_size=0.004, sdf_trunc=0.02,
                             depth_trunc=3.0, bound_scale: float = 1.0,
                             alpha_thres: float = 0.5):
        """Returns (verts, faces, vertex_colors)."""
        t0 = clock(self.device)
        vol = fuse_bounded(self.cameras, self.depthmaps, self.rgbmaps,
                           self.alphamaps, self.device, voxel_size,
                           sdf_trunc, depth_trunc, bound_scale, alpha_thres)
        t1 = clock(self.device)
        mesh = extract_mesh(vol)
        self.seconds["fusion"] += t1 - t0
        self.seconds["mtet"] += time.perf_counter() - t1
        return mesh

    def _fuse_points(self, pts_world, center, radius, trunc_c,
                     alpha_thres: float, with_rgb: bool):
        """TSDF-fuse world points [..., 3] over every captured view with
        bilinear depth, rgb and alpha sampling. Returns (tsdf, rgb or None,
        weight), each shaped like pts_world[..., 0]."""
        shape = pts_world.shape[:-1]
        pts = pts_world.reshape(-1, 3)
        mag = torch.linalg.norm((pts - center) / radius, dim=-1)
        # sdf in contracted units: the world sdf times the local
        # contraction scale (adaptive truncation)
        scale = torch.where(mag > 1.0, 1.0 / (mag * mag), 1.0) / radius
        n = pts.shape[0]
        tsdf = torch.ones(n, device=self.device)
        weight = torch.zeros(n, device=self.device)
        rgbacc = torch.zeros((n, 3), device=self.device) if with_rgb else None
        for depth, rgb, alpha, w2c, fx, fy, cx, cy in device_views(
                self.cameras, self.depthmaps, self.rgbmaps, self.alphamaps,
                self.device):
            H, W = depth.shape
            cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
            z = cam[..., 2]
            zs = torch.where(z != 0, z, 1.0)
            u = cam[..., 0] * fx / zs + cx
            v = cam[..., 1] * fy / zs + cy
            uv = torch.stack([u, v], dim=-1)
            in_img = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) \
                & (z > 0)
            d = bilinear_sample(depth, uv)
            ok = in_img & (d > 0) & (bilinear_sample(alpha, uv) > alpha_thres)
            sdf_c = torch.clamp((d - z) * scale / trunc_c, -1.0, 1.0)
            upd = ok & (sdf_c > -1.0)
            wsum = weight + torch.where(upd, 1.0, 0.0)
            wsafe = torch.clamp(wsum, min=1e-8)
            tsdf = torch.where(upd, (tsdf * weight + sdf_c) / wsafe, tsdf)
            if with_rgb:
                c = torch.stack([bilinear_sample(rgb[..., i], uv)
                                 for i in range(3)], dim=-1)
                rgbacc = torch.where(upd[:, None],
                                     (rgbacc * weight[:, None] + c)
                                     / wsafe[:, None], rgbacc)
            weight = wsum
        rgb_out = rgbacc.reshape(shape + (3,)) if with_rgb else None
        return tsdf.reshape(shape), rgb_out, weight.reshape(shape)

    def extract_mesh_unbounded(self, resolution: int = 512,
                               alpha_thres: float = 0.5):
        """Contracted-space fusion: the grid lives in contracted
        coordinates, each cell is un-contracted to the world and projected
        into every view; vertex colours are fused at the extracted
        vertices afterwards. Returns (verts, faces, vertex_colors)."""
        center, radius = bounding_sphere(self.cameras)
        center = torch.as_tensor(np.asarray(center, np.float32),
                                 device=self.device)
        N = min(resolution, 512)
        t0 = clock(self.device)
        lin = torch.linspace(-2.0, 2.0, N, device=self.device)
        grid_c = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"),
                             dim=-1)
        trunc_c = 2.0 * 4.0 / N    # ~2 voxels in contracted units
        tsdf, _, weight = self._fuse_points(
            uncontract(grid_c, center, radius), center, radius, trunc_c,
            alpha_thres, with_rgb=False)
        tsdf, mask = tsdf.cpu().numpy(), (weight > 0).cpu().numpy()
        t1 = clock(self.device)
        verts_c, faces = marching_tetrahedra_blocked(
            tsdf, level=0.0, spacing=(4.0 / (N - 1),) * 3,
            origin=(-2.0, -2.0, -2.0), mask=mask)
        t2 = time.perf_counter()
        if len(verts_c):
            verts = uncontract(torch.as_tensor(verts_c, dtype=torch.float32,
                                               device=self.device),
                               center, radius)
            _, colors, _ = self._fuse_points(verts, center, radius, trunc_c,
                                             alpha_thres, with_rgb=True)
            verts = verts.cpu().numpy()
            colors = np.clip(colors.cpu().numpy(), 0.0, 1.0)
        else:
            verts = verts_c
            colors = np.zeros((0, 3), np.float32)
        t3 = clock(self.device)
        self.seconds["fusion"] += (t1 - t0) + (t3 - t2)
        self.seconds["mtet"] += t2 - t1
        return verts, faces, colors

    def export_images(self, out_dir: str):
        from PIL import Image
        os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
        for i, (rgb, depth) in enumerate(zip(self.rgbmaps, self.depthmaps)):
            Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)
                            ).save(os.path.join(out_dir, "renders",
                                                f"{i:05d}.png"))
            d = depth / (depth.max() + 1e-9)
            Image.fromarray((d * 255).astype(np.uint8)).save(
                os.path.join(out_dir, "depth", f"{i:05d}.png"))


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                   colors: Optional[np.ndarray] = None):
    """Binary little-endian PLY with a face list. colors: optional [V,3]
    floats in [0,1], written as uchar rgb."""
    with_c = colors is not None and len(colors) == len(verts)
    with open(path, "wb") as f:
        header = [
            "ply", "format binary_little_endian 1.0",
            f"element vertex {len(verts)}",
            "property float x", "property float y", "property float z"]
        if with_c:
            header += ["property uchar red", "property uchar green",
                       "property uchar blue"]
        header += [
            f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header", ""]
        f.write("\n".join(header).encode())
        if with_c:
            rec = np.empty(len(verts),
                           dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
            rec["xyz"] = verts
            rec["rgb"] = np.clip(np.asarray(colors) * 255.0, 0,
                                 255).astype(np.uint8)
            f.write(rec.tobytes())
        else:
            f.write(np.asarray(verts).astype("<f4").tobytes())
        rec = np.empty(len(faces), dtype=[("n", "u1"), ("v", "<i4", (3,))])
        rec["n"] = 3
        rec["v"] = faces
        f.write(rec.tobytes())


def read_mesh_ply(path: str, with_colors: bool = False):
    """Read back a mesh written by write_mesh_ply."""
    with open(path, "rb") as f:
        nv = nf = 0
        has_c = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith(b"property uchar red"):
                has_c = True
            elif line.startswith(b"element face"):
                nf = int(line.split()[-1])
            elif line == b"end_header":
                break
        if has_c:
            rec = np.frombuffer(f.read(15 * nv),
                                dtype=[("xyz", "<f4", (3,)),
                                       ("rgb", "u1", (3,))])
            verts = rec["xyz"]
            colors = rec["rgb"].astype(np.float64) / 255.0
        else:
            verts = np.frombuffer(f.read(12 * nv),
                                  dtype="<f4").reshape(nv, 3)
            colors = None
        rec = np.frombuffer(f.read(13 * nf),
                            dtype=[("n", "u1"), ("v", "<i4", (3,))])
        if with_colors:
            return verts.astype(np.float64), rec["v"].astype(np.int64), \
                colors
        return verts.astype(np.float64), rec["v"].astype(np.int64)
