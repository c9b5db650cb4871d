"""Plain PyTorch PGSR: the yardstick the pgsr cells' training steps are held
against.

Written from the method (Chen et al. 2024, "PGSR: Planar-based Gaussian
Splatting for Efficient and High-Fidelity Surface Reconstruction") and its
published trainer, in plain tensor operations with autograd for every
gradient; it imports nothing of the program. The projection, SH colour,
binning order, alpha walk, SSIM, Adam and the model's start are
portbench/reference/gs3d.py's. What PGSR adds:

* each gaussian's plane: its normal is the rotation's axis of the smallest
  scale (the first of equal ones), flipped to face the camera, taken to
  camera space; its distance is |n . mean| in camera space (the published
  code's abs: with the normal facing the camera it is -n . mean);
* the blend walks the vanilla alpha and transmittance and blends the
  colour, the normal and the distance with the same weights; the plane
  depth of a pixel is distance / -(n . ray + 1e-8), the ray ((x - cx) / fx,
  (y - cy) / fy, 1) through the pixel's integer coordinates, cx = W / 2;
* past `multi_view_from` a step renders a second camera, drawn from the
  step camera's neighbours, and adds three terms to 0.8 L1 + 0.2 D-SSIM:
  - the normal term, lambda_normal times the mean over the pixels of the
    eroded (5 x 5, reflect padding) weight clamp(1 - g, 0, 1)^5, g the
    image's normalised largest absolute central difference (border 1),
    times |normal from the plane depth - blended normal|_1; the normal
    from the plane depth is the cross product of the unprojected points'
    horizontal and vertical central differences, normalised, times the
    detached alpha (zero on the border);
  - the geo term: every pixel's plane-depth point taken into the
    neighbour, its depth there read from the neighbour's plane depth
    (bilinear, border clamp), the point rebuilt at that depth and taken
    back; the reprojection error in pixels; where the pixel lands inside
    the neighbour (x, y > 0, x < W, y < H, depth > 0.1) and the error is
    under pixel_noise_threshold, lambda_geo times the mean of
    exp(-error) (detached) times the error;
  - the NCC term on `num_sample` pixels, drawn as randperm(H W)[:S] of a
    torch.Generator on the run's device seeded with seed 1,000,003 +
    step: the (2 patch_size + 1)^2 patch of the target's grayscale (ITU-R
    601-2) against the neighbour's grayscale warped by the pixel's plane
    homography K_n (R_rel - t_rel n^T / d) K^-1 from the blended normal and
    distance; lambda_ncc times the mean of clamp(1 - cc, 0, 2) times the
    pixel's geo weight over the sampled pixels whose geo mask holds and
    whose NCC is under 0.9;
* the neighbours: covisibility view selection (MVSNet's triangulation-angle
  kernel, theta0 5, sigma 1 and 10) on the scene's COLMAP files, over the
  training list (the cameras by image name, shuffled by Python's
  random.Random(seed)), each camera's `num_multi_view` best in the order
  numpy's argsort gives, reversed; the neighbour of the k-th two-camera
  step of a process is random.Random(((seed mod 2^31) ^ 0x9E3779B9)
  1,000,003 + k).choice of that list.

Departures from the published code, each where the program states the
rule: the plane-depth normal is cross(right - left, bottom - top), the
published code's cross(right - left, top - bottom) negated; the
normalisations multiply by rsqrt(|v|^2 + 1e-12), and the reprojection
error is sqrt(|e|^2 + 1e-12), so that a pixel reprojected onto itself
keeps a finite gradient; a pixel with no blended distance divides the
homography by 1e-8 and a point at depth 0 by 1; the NCC samples every
pixel and masks afterwards, where the published code samples the geo
mask's pixels; every sample is bilinear with border clamp in pixel
coordinates (grid_sample's align_corners, border values, without its
[-1, 1] round trip; the published NCC pads with zeros); PGSR's single-view
flattening loss is not in the preset and not here.

Both renders blend tile group by tile group, as gs3d.py's: the maps are
made without gradients, the loss's gradients with respect to both
renders' maps (colour, normal, distance, transmittance; the image, alpha
and plane depth follow from them) are taken, then each group is blended
again under autograd and its share pushed back to the gaussians' screen
and plane attributes, which the projection's autograd takes to the
parameters.

`dtype` sets the precision of everything (the control runs bfloat16).
"""
from __future__ import annotations

import os
import random
import struct
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import gs3d
from portbench.reference.gs3d import (
    PIX,
    TILE,
    compare,
    configure,
    program_params,
    program_side,
    program_step_state,
    start_gap,
)

__all__ = ["configure", "compare", "program_params", "program_step_state"]

# a planar instance's attributes: the vanilla nine (mean 2, conic 3,
# opacity, colour 3), the camera-space normal 3 and the plane distance
ATTRS = 13
# the blended channels (colour, normal, distance) and the transmittance
CHANNELS = 7
MAPS = CHANNELS + 1
DRAW_MIX = 0x9E3779B9
DRAW_STRIDE = 1_000_003
SAMPLE_STRIDE = 1_000_003

# the least work of a step (portbench/counts.py applies the peaks):
# operations per contributing pair of the planar blend, the alpha and walk
# then the sums forward, the gradient terms backward (csrc/blend_pgsr.cu,
# the kernel table's planar counts, exp as one)
PLANAR_PAIR_OPS = 22
PLANAR_FWD_CONTRIB_OPS = 16
PLANAR_BWD_CONTRIB_OPS = 69
# a planar instance's 13 attribute rows and a pixel's 8 output channels,
# float32
PLANAR_INSTANCE_BYTES = ATTRS * 4
PLANAR_PIXEL_BYTES = MAPS * 4
# the multi-view terms, forward and twice that backward, from their
# formulas: per pixel, the plane depth, its normal, the image weight and
# the normal term (~70 forward), and the geo term's two transforms, two
# projections, bilinear sample and error (~130 forward); per NCC sample,
# the homography (~117) and per tap the warp (17), the neighbour's
# bilinear sample (12) and the NCC sums (8), the target's sample once
# (12), backward through the neighbour's path
NORMAL_PIXEL_OPS = 210
GEO_PIXEL_OPS = 390
NCC_SAMPLE_OPS = 117 * 3 + 49 * (12 + 3 * (17 + 12 + 8))


# ---------------------------------------------------------------------------
# the neighbours
# ---------------------------------------------------------------------------

def read_images_bin(path: str) -> Dict[str, tuple]:
    """COLMAP images.bin: {name: (qvec, tvec, point3D ids)}."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            _, *pose, _ = struct.unpack("<i7di", f.read(64))
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (m,) = struct.unpack("<Q", f.read(8))
            pts = np.frombuffer(f.read(24 * m), dtype=[
                ("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            out[name.decode()] = (np.asarray(pose[:4]), np.asarray(pose[4:]),
                                  pts["id"].copy())
    return out


def read_points3d_bin(path: str) -> Dict[int, np.ndarray]:
    """COLMAP points3D.bin: {point3D id: xyz}."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            pid, x, y, z = struct.unpack("<Q3d", f.read(32))
            f.read(3 + 8)
            (m,) = struct.unpack("<Q", f.read(8))
            f.read(8 * m)
            out[pid] = np.array([x, y, z])
    return out


def covisibility(centres: np.ndarray, point_ids: List[np.ndarray],
                 xyz: Dict[int, np.ndarray], theta0: float = 5.0,
                 sigma1: float = 1.0, sigma2: float = 10.0) -> np.ndarray:
    """MVSNet's pair scores: over the points two images share, the sum of
    exp(-(theta - theta0)^2 / (2 sigma^2)), theta the triangulation angle
    in degrees, sigma sigma1 at or under theta0 and sigma2 above; 0 on the
    diagonal."""
    n = len(centres)
    ids = [set(int(i) for i in p if i >= 0 and int(i) in xyz)
           for p in point_ids]
    score = np.zeros((n, n))
    for i in range(n):
        for j in range(i + 1, n):
            common = sorted(ids[i] & ids[j])
            if not common:
                continue
            p = np.stack([xyz[k] for k in common])
            a, b = centres[i] - p, centres[j] - p
            cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1) + 1e-12)
            theta = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
            sigma = np.where(theta <= theta0, sigma1, sigma2)
            score[i, j] = score[j, i] = float(np.exp(
                -(theta - theta0) ** 2 / (2 * sigma ** 2)).sum())
    return score


def training_list(scene, seed: int) -> List[str]:
    """The training cameras' names in the loader's order: by image name,
    shuffled by random.Random(seed)."""
    names = [c.name for c in scene.train_order()]
    random.Random(seed).shuffle(names)
    return names


def neighbour_lists(scene, seed: int, views: int) -> Dict[str, List[str]]:
    """Each training camera's `views` best covisible cameras."""
    sparse = os.path.join(scene.root, "sparse", "0")
    images = read_images_bin(os.path.join(sparse, "images.bin"))
    xyz = read_points3d_bin(os.path.join(sparse, "points3D.bin"))
    names = training_list(scene, seed)
    poses = [images[n + ".png"] for n in names]
    centres = np.stack([-gs3d.qvec_to_rotmat(q).T @ t for q, t, _ in poses])
    score = covisibility(centres, [p[2] for p in poses], xyz)
    return {n: [names[k] for k in np.argsort(score[i])[::-1][:views]]
            for i, n in enumerate(names)}


def draw(near: List[str], seed: int, k: int) -> str:
    """The neighbour of the process's k-th two-camera step."""
    rng = random.Random(((seed % (1 << 31)) ^ DRAW_MIX) * DRAW_STRIDE + k)
    return rng.choice(list(near))


# ---------------------------------------------------------------------------
# cameras and sampling
# ---------------------------------------------------------------------------

def camera_tensors(cam, device, dtype=torch.float32) -> dict:
    """gs3d.camera_tensors with the principal point (the image's centre)
    and the intrinsics K and K^-1."""
    c = gs3d.camera_tensors(cam, device, dtype)
    fx, fy = c["fx"], c["fy"]
    cx = torch.tensor(cam.width / 2.0, device=device, dtype=dtype)
    cy = torch.tensor(cam.height / 2.0, device=device, dtype=dtype)
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    c.update(cx=cx, cy=cy, K=torch.stack([
        torch.stack([fx, z, cx]), torch.stack([z, fy, cy]),
        torch.stack([z, z, o])]), K_inv=torch.stack([
            torch.stack([1.0 / fx, z, -cx / fx]),
            torch.stack([z, 1.0 / fy, -cy / fy]), torch.stack([z, z, o])]))
    return c


def rays(cam, height: int, width: int):
    """Per pixel (rx, ry) [H, W]: the camera-space ray (rx, ry, 1)."""
    dt = cam["fx"].dtype
    dev = cam["fx"].device
    rx = (torch.arange(width, dtype=dt, device=dev) - cam["cx"]) / cam["fx"]
    ry = (torch.arange(height, dtype=dt, device=dev) - cam["cy"]) / cam["fy"]
    return rx[None, :].expand(height, width), ry[:, None].expand(height,
                                                                 width)


def sample(img, x, y):
    """img [H, W] or [H, W, C] at pixel coordinates x, y (any shape),
    bilinear with border clamp. The corner is an integer clamped to the
    image, whatever the dtype can hold (bfloat16 rounds 1599 to 1600)."""
    H, W = img.shape[:2]
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.clamp(torch.floor(x).long(), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 2)
    wx, wy = x - x0.to(x.dtype), y - y0.to(y.dtype)
    i = (y0 * W + x0).reshape(-1)
    f = img.reshape(H * W, -1)
    wx, wy = wx.reshape(-1, 1), wy.reshape(-1, 1)
    out = (1 - wy) * ((1 - wx) * f[i] + wx * f[i + 1]) \
        + wy * ((1 - wx) * f[i + W] + wx * f[i + W + 1])
    return out.reshape(x.shape + img.shape[2:])


def unit(v):
    return v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def gray(img):
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


# ---------------------------------------------------------------------------
# a render
# ---------------------------------------------------------------------------

def planar_attrs(leaves, cam, sh_degree: int, active, width: int,
                 height: int):
    """(the projection, the planar screen attributes [N, 13])."""
    proj = gs3d.project(leaves, cam, sh_degree, active, width, height)
    xyz = leaves["xyz"]
    R = gs3d.rotation_matrices(leaves["rotation"])
    axis = torch.argmin(leaves["scaling"].detach(), -1)
    n = torch.gather(R, 2, axis[:, None, None].expand(-1, 3, 1))[..., 0]
    away = ((cam["campos"] - xyz) * n).sum(-1) < 0
    n = torch.where(away[:, None], -n, n)
    Rw, tw = cam["w2c"][:3, :3], cam["w2c"][:3, 3]
    n_cam = n @ Rw.T
    dist = (n_cam * (xyz @ Rw.T + tw)).sum(-1).abs()
    return proj, torch.cat([gs3d.screen_attrs(proj), n_cam, dist[:, None]],
                           1)


def blend_group(attrs, gid, start, tiles, K: int, tiles_x: int):
    """One tile group's blended channels [G, PIX, 7] and final
    transmittance [G, PIX]."""
    A, alpha, ok = gs3d.group_alpha(attrs, gid, start, tiles, K, tiles_x)
    before, contrib = gs3d.walk(alpha, ok)
    w = torch.where(contrib, alpha * before, torch.zeros_like(alpha))
    return w @ A[..., 6:ATTRS], torch.where(
        contrib, 1.0 - alpha, torch.ones_like(alpha)).prod(-1)


class Render:
    """One camera's render: its attributes (in autograd), binning and the
    padded maps [H_pad, W_pad, 8] (colour, normal, distance, final T)."""

    def __init__(self, leaves, cam, sh_degree: int, active, width: int,
                 height: int):
        self.cam = cam
        self.tiles_x, self.tiles_y = -(-width // TILE), -(-height // TILE)
        proj, self.attrs = planar_attrs(leaves, cam, sh_degree, active,
                                        width, height)
        self.gid, self.start = gs3d.bin_tiles(proj, self.tiles_x,
                                              self.tiles_y)
        self.groups = gs3d.tile_groups(self.start)
        n_tiles = self.tiles_x * self.tiles_y
        a0 = self.attrs.detach()
        with torch.no_grad():
            out = torch.zeros(n_tiles, PIX, MAPS, dtype=a0.dtype,
                              device=a0.device)
            out[..., CHANNELS] = 1.0
            for tiles, K in self.groups:
                ch, t = blend_group(a0, self.gid, self.start, tiles, K,
                                    self.tiles_x)
                out[tiles] = torch.cat([ch, t[..., None]], -1)
            self.maps = gs3d.tiles_to_image(
                out, torch.arange(n_tiles, device=a0.device), self.tiles_x,
                self.tiles_y, MAPS)

    def attr_grad(self, cot):
        """The gradient of the attributes from the maps' cotangent, tile
        group by tile group."""
        a1 = self.attrs.detach().clone().requires_grad_(True)
        for tiles, K in self.groups:
            ch, t = blend_group(a1, self.gid, self.start, tiles, K,
                                self.tiles_x)
            c = gs3d.image_to_tiles(cot, tiles, self.tiles_x, self.tiles_y)
            torch.autograd.backward([ch, t], [c[..., :CHANNELS],
                                              c[..., CHANNELS]])
        return a1.grad


def maps_of(padded, cam, width: int, height: int, bg) -> dict:
    m = padded[:height, :width]
    normal, dist, T = m[..., 3:6], m[..., 6], m[..., 7]
    rx, ry = rays(cam, height, width)
    return dict(image=m[..., :3] + T[..., None] * bg, normal=normal,
                distance=dist, alpha=1.0 - T,
                depth=dist / -(normal[..., 0] * rx + normal[..., 1] * ry
                               + normal[..., 2] + 1e-8))


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def grad_weight(img):
    """The normalised largest absolute central difference per pixel (mean
    over the channels), border 1."""
    gx = (img[1:-1, 2:] - img[1:-1, :-2]).abs().mean(-1)
    gy = (img[:-2, 1:-1] - img[2:, 1:-1]).abs().mean(-1)
    g = torch.maximum(gx, gy)
    g = (g - g.min()) / (g.max() - g.min() + 1e-12)
    return F.pad(g, (1, 1, 1, 1), value=1.0)


def erode(x, k: int = 5):
    """The k x k minimum with reflect padding (1 - dilation of 1 - x)."""
    p = (k - 1) // 2
    y = F.pad((1.0 - x)[None, None], (p, p, p, p), mode="reflect")
    return 1.0 - F.max_pool2d(y, k, stride=1)[0, 0]


def depth_normal(depth, alpha, cam):
    H, W = depth.shape
    rx, ry = rays(cam, H, W)
    pts = torch.stack([rx * depth, ry * depth, depth], -1)
    n = unit(cross(pts[1:-1, 2:] - pts[1:-1, :-2],
                   pts[2:, 1:-1] - pts[:-2, 1:-1]))
    return F.pad(n, (0, 0, 1, 1, 1, 1)) * alpha.detach()[..., None]


def geo(ref: dict, near: dict, cam, near_cam, st: dict):
    """(the geo term, its mask [H W], its detached weights [H W], the pixels'
    coordinates [H W, 2])."""
    depth = ref["depth"]
    H, W = depth.shape
    rx, ry = rays(cam, H, W)
    pts = torch.stack([rx * depth, ry * depth, depth], -1).reshape(-1, 3)
    R, t = cam["w2c"][:3, :3], cam["w2c"][:3, 3]
    Rn, tn = near_cam["w2c"][:3, :3], near_cam["w2c"][:3, 3]
    pn = ((pts - t) @ R) @ Rn.T + tn
    z = pn[:, 2]
    zs = torch.where(z != 0, z, torch.ones_like(z))
    px = pn[:, 0] * near_cam["fx"] / zs + near_cam["cx"]
    py = pn[:, 1] * near_cam["fy"] / zs + near_cam["cy"]
    inside = (px > 0) & (px < W) & (py > 0) & (py < H) & (z > 0.1)
    z_near = sample(near["depth"], px, py)
    back = ((pn / zs[:, None] * z_near[:, None] - tn) @ Rn) @ R.T + t
    zv = back[:, 2]
    zv = torch.where(zv != 0, zv, torch.ones_like(zv))
    iy, ix = torch.meshgrid(torch.arange(H, dtype=depth.dtype,
                                         device=depth.device),
                            torch.arange(W, dtype=depth.dtype,
                                         device=depth.device), indexing="ij")
    pix = torch.stack([ix, iy], -1).reshape(-1, 2)
    err = torch.stack([back[:, 0] * cam["fx"] / zv + cam["cx"],
                       back[:, 1] * cam["fy"] / zv + cam["cy"]], -1) - pix
    noise = torch.sqrt((err * err).sum(-1) + 1e-12)
    mask = inside & (noise < st["pixel_noise_threshold"])
    w = torch.where(mask, torch.exp(-noise).detach(), torch.zeros_like(noise))
    count = torch.clamp(mask.to(depth.dtype).sum(), min=1.0)
    return st["lambda_geo"] * (w * noise).sum() / count, mask, w, pix


def lncc(ref, nea):
    """(clamp(1 - cc, 0, 2), its < 0.9 mask) of [S, P] patches."""
    P = ref.shape[-1]
    rs, ns = ref.sum(-1), nea.sum(-1)
    cross_ = (ref * nea).sum(-1) - ns / P * rs
    rv = (ref * ref).sum(-1) - rs / P * rs
    nv = (nea * nea).sum(-1) - ns / P * ns
    ncc = torch.clamp(1.0 - cross_ * cross_ / (rv * nv + 1e-8), 0.0, 2.0)
    return ncc, ncc < 0.9


def ncc_sample(pixels: int, st: dict, seed: int, step: int, device):
    """The NCC's pixel sample: all pixels, or randperm(pixels)[:S] of a
    generator on the device seeded with seed 1,000,003 + step."""
    S = min(st["num_sample"], pixels)
    if S == pixels:
        return torch.arange(pixels, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed % (1 << 31)) * SAMPLE_STRIDE + step)
    return torch.randperm(pixels, generator=gen, device=device)[:S]


def ncc(ref: dict, cam, near_cam, gt_gray, near_gray, mask, w, pix, idx,
        st: dict):
    h = st["patch_size"]
    dt = gt_gray.dtype
    r = torch.arange(-h, h + 1, dtype=dt, device=gt_gray.device)
    off = torch.stack(torch.meshgrid(r, r, indexing="xy"), -1).reshape(-1,
                                                                       2)
    patch = pix[idx][:, None, :] + off[None]
    ref_vals = sample(gt_gray, patch[..., 0], patch[..., 1]).detach()
    R, t = cam["w2c"][:3, :3], cam["w2c"][:3, 3]
    Rn, tn = near_cam["w2c"][:3, :3], near_cam["w2c"][:3, 3]
    rel = Rn @ R.T
    t_rel = -rel @ t + tn
    n = ref["normal"].reshape(-1, 3)[idx]
    d = ref["distance"].reshape(-1)[idx]
    d = torch.where(d.abs() > 1e-8, d, torch.full_like(d, 1e-8))
    Hm = rel[None] - t_rel[None, :, None] * n[:, None, :] / d[:, None, None]
    Hm = near_cam["K"][None] @ Hm @ cam["K_inv"][None]
    hom = torch.cat([patch, torch.ones_like(patch[..., :1])], -1)
    warped = torch.einsum("sij,spj->spi", Hm, hom)
    warped = warped[..., :2] / (warped[..., 2:] + 1e-10)
    near_vals = sample(near_gray, warped[..., 0], warped[..., 1])
    cc, ok = lncc(ref_vals, near_vals)
    m = mask[idx] & ok
    count = torch.clamp(m.to(dt).sum(), min=1.0)
    return st["lambda_ncc"] * torch.where(m, cc * w[idx],
                                          torch.zeros_like(cc)).sum() / count


def loss_terms(ref: dict, near: Optional[dict], gt, near_gt, cam, near_cam,
               st: dict, idx) -> Dict[str, torch.Tensor]:
    """The step's terms by the program's names."""
    lam = st["lambda_dssim"]
    terms = {"L1_loss": (1 - lam) * (ref["image"] - gt).abs().mean(),
             "ssim_loss": lam * (1 - gs3d.ssim(ref["image"], gt))}
    if near is None:
        return terms
    weight = erode(torch.clamp(1.0 - grad_weight(gt), 0.0, 1.0) ** 5)
    dn = depth_normal(ref["depth"], ref["alpha"], cam)
    terms["normal_loss"] = st["lambda_normal"] * (
        weight * (dn - ref["normal"]).abs().sum(-1)).mean()
    terms["geo_loss"], mask, w, pix = geo(ref, near, cam, near_cam, st)
    terms["ncc_loss"] = ncc(ref, cam, near_cam, gray(gt), gray(near_gt),
                            mask, w, pix, idx, st)
    return terms


# ---------------------------------------------------------------------------
# a step
# ---------------------------------------------------------------------------

def step_grads(params, cam, near_cam, gt, near_gt, sh_degree: int, active,
               width: int, height: int, bg, st: dict, idx):
    """(the terms, the gradients of their sum w.r.t. every leaf of params)
    of one step on `cam`, with the neighbour `near_cam` or None."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    renders = [Render(leaves, c, sh_degree, active, width, height)
               for c in ([cam] if near_cam is None else [cam, near_cam])]
    padded = [r.maps.detach().requires_grad_(True) for r in renders]
    maps = [maps_of(p, r.cam, width, height, bg)
            for p, r in zip(padded, renders)]
    terms = loss_terms(maps[0], maps[1] if near_cam is not None else None,
                       gt, near_gt, cam, near_cam, st, idx)
    cots = torch.autograd.grad(sum(terms.values()), padded)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for r, cot in zip(renders, cots):
        got = torch.autograd.grad(r.attrs, [leaves[k] for k in params],
                                  grad_outputs=r.attr_grad(cot),
                                  allow_unused=True)
        for k, g in zip(params, got):
            if g is not None:
                grads[k] = grads[k] + g
    return {k: v.detach() for k, v in terms.items()}, grads


class Steps:
    """The reference's steps on one scene and seed: its cameras, targets,
    neighbour lists and the process's count of two-camera steps."""

    def __init__(self, cell, scene, seed: int, device, dtype):
        self.cell, self.scene, self.device, self.dtype = (cell, scene,
                                                          device, dtype)
        self.st = cell.settings
        self.seed = seed % (1 << 31)
        self.near = neighbour_lists(scene, self.seed,
                                    self.st["num_multi_view"])
        self.active = torch.arange(cell.capacity, device=device) \
            < cell.points
        self.bg = torch.zeros(3, device=device, dtype=dtype)

    def camera(self, name: str):
        c = self.scene.camera(name)
        return camera_tensors(c, self.device, self.dtype), torch.as_tensor(
            self.scene.image(c), device=self.device).to(self.dtype)

    def neighbour(self, name: str, k: int) -> str:
        return draw(self.near[name], self.seed, k)

    def multi_view(self, step: int) -> bool:
        return step > self.st["multi_view_from"]

    def step(self, params, name: str, step: int, k: int):
        """(terms, gradients, the neighbour's name or None) of `step` on
        the camera `name`, k the process's count of two-camera steps
        before it."""
        st = self.st
        deg = min(step // st["gaussians.oneup_sh_interval"],
                  st["gaussians.max_sh_degree"])
        cam, gt = self.camera(name)
        near_name, near_cam, near_gt = None, None, None
        if self.multi_view(step):
            near_name = self.neighbour(name, k)
            near_cam, near_gt = self.camera(near_name)
        W, H = self.scene.width, self.scene.height
        idx = ncc_sample(W * H, st, self.seed, step, self.device)
        terms, grads = step_grads(params, cam, near_cam, gt, near_gt, deg,
                                  self.active, W, H, self.bg, st, idx)
        return terms, grads, near_name

    def train(self, params: Dict[str, torch.Tensor], cameras: List[str],
              first_step: int, k: int = 0) -> dict:
        """Train on `cameras` from `params` (Adam's moments at zero), step
        first_step + i on cameras[i]. Returns the losses, each step's terms,
        the first step's gradients and the parameters after the last
        step."""
        st = self.st
        extent = gs3d.scene_extent(self.scene.cams)
        m = {k_: torch.zeros_like(p) for k_, p in params.items()}
        v = {k_: torch.zeros_like(p) for k_, p in params.items()}
        losses, terms_all, first = [], [], None
        for i, name in enumerate(cameras):
            step = first_step + i
            terms, grads, near = self.step(params, name, step, k)
            k += near is not None
            terms_all.append({t: float(x) for t, x in terms.items()})
            losses.append(float(sum(terms.values())))
            if first is None:
                first = {k_: g.detach().clone() for k_, g in grads.items()}
            with torch.no_grad():
                params = gs3d.adam(params, grads, m, v, i + 1,
                                   gs3d.learning_rates(step, extent, st))
        return {"losses": losses, "terms": terms_all, "grads": first,
                "params": params}


# ---------------------------------------------------------------------------
# the harness's interface (portbench/harness.py)
# ---------------------------------------------------------------------------

def reference_steps(cell, scene, before, cameras, device, dtype,
                    seed: int) -> dict:
    """This file's three steps from `before` on the named cameras, the
    process's first two-camera steps."""
    params = {k: v.to(device).to(dtype) for k, v in before.items()}
    return Steps(cell, scene, seed, device, dtype).train(
        params, list(cameras), cell.start_step + 1)


def readings(cell, scene, steps, device, seed: int,
             per_leaf: Optional[dict] = None) -> Dict[str, float]:
    """The program's numbers: its steps against this file's."""
    ref = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          torch.float32, seed)
    nums = compare(program_side(steps), ref, steps.before, device, per_leaf)
    nums["start_gap"] = start_gap(cell, scene, steps.before, device, seed)
    return nums


def control_readings(cell, scene, steps, device, seed: int,
                     dtype=torch.bfloat16) -> Dict[str, float]:
    """The control's numbers: this file in `dtype` put in the program's
    place, from the same start on the same cameras."""
    ref = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          torch.float32, seed)
    low = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          dtype, seed)
    side = {"losses": low["losses"],
            "grads": {k: g.float() for k, g in low["grads"].items()},
            "params": {k: p.float() for k, p in low["params"].items()}}
    nums = compare(side, ref, steps.before, device)
    own = {k: v.to(dtype).float() for k, v in steps.before.items()}
    nums["start_gap"] = start_gap(cell, scene, own, device, seed)
    return nums


def judge(cell, scene, steps, device, seed: int) -> dict:
    """Each number compared, beside its limit (the cell's `limits`)."""
    nums = readings(cell, scene, steps, device, seed)
    return {k: {"value": v, "limit": cell.limits[k]}
            for k, v in nums.items()}


def planar_step(renders: List[tuple], samples: int, capacity: int,
                width: int, height: int) -> dict:
    """One two-camera PGSR step's least work from each render's
    (contributing pairs, instances, visible gaussians): each planar blend
    kernel's operations and bytes over the step's renders, and the whole
    step's operations."""
    pixels = width * height
    pairs = sum(r[0] for r in renders)
    inst = sum(r[1] for r in renders)
    n = len(renders)
    fwd = {"ops": (PLANAR_PAIR_OPS + PLANAR_FWD_CONTRIB_OPS) * pairs,
           "bytes": inst * PLANAR_INSTANCE_BYTES
           + n * pixels * PLANAR_PIXEL_BYTES}
    bwd = {"ops": (PLANAR_PAIR_OPS + PLANAR_BWD_CONTRIB_OPS) * pairs,
           "bytes": 2 * inst * PLANAR_INSTANCE_BYTES
           + 2 * n * pixels * PLANAR_PIXEL_BYTES}
    from portbench import counts
    step = (fwd["ops"] + bwd["ops"]
            + counts.GAUSSIAN_OPS * sum(r[2] for r in renders)
            + counts.LOSS_OPS_PER_CHANNEL * 3 * pixels
            + counts.ADAM_OPS_PER_ELEMENT * counts.VANILLA_ELEMENTS
            * capacity)
    if n > 1:
        step += (NORMAL_PIXEL_OPS + GEO_PIXEL_OPS) * pixels \
            + NCC_SAMPLE_OPS * samples
    return {"blend_pgsr_fwd": fwd, "blend_pgsr_bwd": bwd,
            "step": {"ops": step}}


def work(cell, scene, params, cameras, device, samples: int = 2) -> dict:
    """The work of the traced steps, from `params` (the model at the
    window's start) on the first `samples` of their cameras, each with a
    neighbour's render past multi_view_from. The harness does not hand this
    function the run's seed, which draws the neighbour and, through the
    loader's shuffle, orders the neighbour lists; so the neighbour's render
    counts as the mean of every training camera's."""
    st = cell.settings
    p = {k: v.to(device) for k, v in params.items()}
    active = torch.arange(cell.capacity, device=device) < cell.points
    first = cell.start_step + 3 + cell.warmup_steps + 1
    deg = min(first // st["gaussians.oneup_sh_interval"],
              st["gaussians.max_sh_degree"])
    names = list(cameras[:samples])
    multi = first > st["multi_view_from"]
    pool = [c.name for c in scene.train_order()] if multi else names
    seen = {n: gs3d.pair_counts(p, camera_tensors(scene.camera(n), device),
                                deg, active, scene.width, scene.height)
            for n in dict.fromkeys(names + pool)}
    mean = tuple(sum(seen[n][j] for n in pool) / len(pool) for j in range(3))
    rows = [planar_step([seen[n]] + ([mean] if multi else []),
                        min(st["num_sample"], scene.width * scene.height),
                        cell.capacity, scene.width, scene.height)
            for n in names]
    return {k: {q: sum(r[k][q] for r in rows) / len(rows)
                for q in rows[0][k]} for k in rows[0]}
