"""Plain PyTorch 3D Gaussian Splatting: the yardstick the 3dgs cells' training
steps are held against.

Written from the method (Kerbl et al. 2023, "3D Gaussian Splatting for
Real-Time Radiance Field Rendering") and its reference trainer, in plain
tensor operations with autograd for every gradient. It imports nothing of
the program. Where the program states a rule that decides the result, this
file follows the rule, not the program's code:

* EWA projection with the 0.3 low-pass dilation and the 1.3 x tan(fov)
  clamp; a gaussian is drawn when its view depth exceeds 0.2, its 2-D
  covariance is positive definite and 255 x opacity exceeds 1;
* each gaussian covers the 16 x 16 tiles of a rect whose half extents per
  axis are ceil(s sqrt(cov_axis)) pixels, s = min(3, sqrt(2 ln(255 op))):
  the 3-sigma box, tightened to the alpha >= 1/255 level set;
* within a tile gaussians blend front to back in the order of a sort key
  that keeps the top 32 - bits(tiles + 1) bits of the float depth (ties in
  gaussian order);
* alpha = min(0.99, op exp(power)), skipped unless power <= 0 and alpha >=
  1/255; a pixel stops at the first gaussian whose (1 - alpha) would take
  its transmittance below 1e-4;
* the loss is 0.8 L1 + 0.2 (1 - SSIM) (11 x 11 gaussian window, sigma 1.5,
  zero padding); Adam with eps 1e-15 and the reference trainer's learning
  rates, the position rate decaying exponentially over 30k steps.

The blend runs tile group by tile group, so a step of millions of gaussians
fits: a forward pass without gradients makes the image, the loss's gradient
with respect to the image is taken, then each group is blended again under
autograd and its part of that gradient pushed back to the per-gaussian
screen attributes, which the projection's autograd takes to the parameters.

`dtype` sets the precision of everything (the control runs bfloat16).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
PIX = TILE * TILE
NEAR = 0.2
DILATE = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
ZNEAR, ZFAR = 0.01, 100.0
# (pixel, instance) pairs a tile group may hold at once
GROUP_PAIRS = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

LEAVES = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def qvec_to_rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def camera_tensors(cam, device, dtype=torch.float32) -> dict:
    """A scene camera (portbench/scene.py) as the tensors a render takes:
    world-to-camera and full projection (OpenGL style, z in [0, 1]), centre,
    focal lengths and half-angle tangents."""
    fovx = 2.0 * math.atan(cam.width / (2.0 * cam.fx))
    fovy = 2.0 * math.atan(cam.height / (2.0 * cam.fy))
    Rt = np.eye(4)
    Rt[:3, :3] = qvec_to_rotmat(cam.qvec)
    Rt[:3, 3] = cam.tvec
    w2c = np.linalg.inv(np.linalg.inv(Rt)).astype(np.float32)
    tx, ty = math.tan(fovx / 2), math.tan(fovy / 2)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[3, 2] = 1.0
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    full = P @ w2c
    centre = np.linalg.inv(w2c.astype(np.float64))[:3, 3].astype(np.float32)

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device).to(
            dtype)
    return dict(w2c=t(w2c), full_proj=t(full), campos=t(centre),
                fx=t(cam.width / (2 * tx)), fy=t(cam.height / (2 * ty)),
                tan_fovx=t(tx), tan_fovy=t(ty), centre=centre)


def scene_extent(cams) -> float:
    """1.1 times the largest distance of a camera centre from their mean."""
    c = np.stack([camera_tensors(k, "cpu")["centre"] for k in cams])
    return float(np.max(np.linalg.norm(c - c.mean(0), axis=1)) * 1.1)


# ---------------------------------------------------------------------------
# the model's start, from the points
# ---------------------------------------------------------------------------

def initial_leaves(xyz: np.ndarray, rgb: np.ndarray, capacity: int,
                   sh_degree: int) -> Dict[str, np.ndarray]:
    """Every leaf of the initial model but the scales: the points, their
    colours as the DC SH coefficient, zero higher coefficients, identity
    rotations and opacity 0.1; the slots past the points hold scale and
    opacity logits of -10. Float32 numpy."""
    n = len(xyz)
    K = (sh_degree + 1) ** 2

    def slots(arr, shape, fill=0.0):
        out = np.full((capacity,) + shape, fill, np.float32)
        out[:n] = arr
        return out
    colors = (rgb.astype(np.float64) / 255.0).astype(np.float32)
    return {
        "xyz": slots(xyz, (3,)),
        "f_dc": slots(((colors - 0.5) / SH_C0)[:, None, :], (1, 3)),
        "f_rest": np.zeros((capacity, K - 1, 3), np.float32),
        "rotation": slots(np.tile(np.float32([1, 0, 0, 0]), (n, 1)), (4,),
                          1.0),
        "opacity": slots(np.full((n, 1), math.log(0.1 / 0.9), np.float32),
                         (1,), -10.0),
    }


def knn_scale(xyz: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """log sqrt of the mean squared distance from each point in `rows` to its
    3 nearest other points, by brute force over all points."""
    d2 = torch.cdist(xyz[rows].double(), xyz.double()) ** 2
    d2[torch.arange(len(rows)), rows] = float("inf")
    near = torch.topk(d2, 3, largest=False).values.mean(1)
    return torch.log(torch.sqrt(torch.clamp(near, min=1e-7)))


# ---------------------------------------------------------------------------
# projection and colour
# ---------------------------------------------------------------------------

def eval_sh(deg: int, sh, d):
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    out = SH_C0 * sh[:, 0]
    if deg > 0:
        out = out - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
               + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6]
               + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
               + SH_C3[1] * xy * z * sh[:, 10]
               + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
               + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
               + SH_C3[5] * z * (xx - yy) * sh[:, 14]
               + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return out


def rotation_matrices(q):
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def project(params, cam, sh_degree: int, active, width: int, height: int):
    """Screen attributes of every gaussian: a dict of mean2d [N, 2], conic
    [N, 3] (xx, xy, yy), opacity [N], colour [N, 3] (differentiable), and
    depth, visible and the tile rect (x0, y0, x1, y1) [N, 4] (not)."""
    xyz = params["xyz"]
    dt = xyz.dtype
    scale = torch.exp(params["scaling"])
    op = torch.sigmoid(params["opacity"])[:, 0]
    R = rotation_matrices(params["rotation"])
    M = R * scale[:, None, :]
    cov3 = M @ M.transpose(1, 2)

    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1)
    p_view = hom @ cam["w2c"][:3, :].T
    p_hom = hom @ cam["full_proj"].T
    p_proj = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    depth = p_view[:, 2]
    front = (depth > NEAR) & active
    tz = torch.where(front, depth, torch.ones_like(depth))
    limx, limy = 1.3 * cam["tan_fovx"], 1.3 * cam["tan_fovy"]
    u = torch.clamp(p_view[:, 0] / tz, -limx, limx)
    v = torch.clamp(p_view[:, 1] / tz, -limy, limy)
    zero = torch.zeros_like(tz)
    J = torch.stack([cam["fx"] / tz, zero, -cam["fx"] * u / tz,
                     zero, cam["fy"] / tz, -cam["fy"] * v / tz],
                    -1).reshape(-1, 2, 3)
    T = J @ cam["w2c"][:3, :3]
    cov2 = T @ cov3 @ T.transpose(1, 2)
    a = cov2[:, 0, 0] + DILATE
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + DILATE
    det = a * c - b * b
    visible = front & (det > 0) & (op.detach() * 255.0 > 1.0)
    det_s = torch.where(visible, det, torch.ones_like(det))
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], 1)

    pad_w = -(-width // TILE) * TILE
    pad_h = -(-height // TILE) * TILE
    pp = torch.where(front[:, None], p_proj, torch.zeros_like(p_proj))
    mean2d = torch.stack([((pp[:, 0] + 1.0) * pad_w - 1.0) * 0.5,
                          ((pp[:, 1] + 1.0) * pad_h - 1.0) * 0.5], 1)

    dirs = xyz - cam["campos"]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    sh = torch.cat([params["f_dc"], params["f_rest"]], 1)
    color = torch.clamp(eval_sh(sh_degree, sh, dirs) + 0.5, min=0.0)

    with torch.no_grad():
        opd = op.detach()
        s = torch.clamp(torch.sqrt(2.0 * torch.log(torch.clamp(
            opd * 255.0, min=1.0 + 1e-6))), max=3.0)
        rx = torch.ceil(s * torch.sqrt(torch.clamp(a.detach(), min=1e-12)))
        ry = torch.ceil(s * torch.sqrt(torch.clamp(c.detach(), min=1e-12)))
        m = mean2d.detach()
        tiles_x, tiles_y = pad_w // TILE, pad_h // TILE
        rect = torch.stack([
            torch.clamp(torch.floor((m[:, 0] - rx) / TILE), 0, tiles_x),
            torch.clamp(torch.floor((m[:, 1] - ry) / TILE), 0, tiles_y),
            torch.clamp(torch.floor((m[:, 0] + rx) / TILE) + 1, 0, tiles_x),
            torch.clamp(torch.floor((m[:, 1] + ry) / TILE) + 1, 0, tiles_y),
        ], 1).long()
        area = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
        visible = visible & (area > 0)
    return dict(mean2d=mean2d, conic=conic, opacity=op, color=color,
                depth=depth.detach().to(dt), visible=visible, rect=rect)


# ---------------------------------------------------------------------------
# binning and blending
# ---------------------------------------------------------------------------

def bin_tiles(proj, tiles_x: int, tiles_y: int):
    """The depth-ordered gaussian list of every tile: (gid [I] in tile order,
    start [tiles + 1]), I the (tile, gaussian) instances of visible
    gaussians."""
    vis = torch.nonzero(proj["visible"]).flatten()
    rect = proj["rect"][vis]
    w = rect[:, 2] - rect[:, 0]
    area = w * (rect[:, 3] - rect[:, 1])
    owner = torch.repeat_interleave(torch.arange(len(vis), device=vis.device),
                                    area)
    first = torch.cumsum(area, 0) - area
    local = torch.arange(len(owner), device=vis.device) - first[owner]
    tx = rect[owner, 0] + local % w[owner]
    ty = rect[owner, 1] + local // w[owner]
    tile = ty * tiles_x + tx
    n_tiles = tiles_x * tiles_y
    depth_bits = 32 - int(n_tiles + 1).bit_length()
    bits = proj["depth"].float()[vis].contiguous().view(torch.int32).long()
    key = (tile << depth_bits) | (bits[owner] >> (31 - depth_bits))
    order = torch.sort(key, stable=True).indices
    gid = vis[owner[order]]
    counts = torch.bincount(tile, minlength=n_tiles)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return gid, start


def tile_groups(start, budget: int = GROUP_PAIRS):
    """Non-empty tiles in groups of similar list length: (tiles [G], K)
    pairs, each group padded to its longest list K with G PIX K <= budget
    (or a single tile)."""
    counts = start[1:] - start[:-1]
    order = torch.argsort(counts, descending=True, stable=True)
    c = counts[order].tolist()
    groups, i = [], 0
    while i < len(c) and c[i] > 0:
        k = c[i]
        g = max(1, budget // (PIX * k))
        j = i
        while j < len(c) and j - i < g and c[j] > 0:
            j += 1
        groups.append((order[i:j], k))
        i = j
    return groups


def group_alpha(attrs, gid, start, tiles, K: int, tiles_x: int):
    """Alpha of every (tile, pixel, list entry) of one tile group: attrs [N,
    9] (mx, my, cxx, cxy, cyy, op, r, g, b). Returns (the entries' attrs [G,
    K, 9], alpha [G, PIX, K], zero where skipped, and where it is not)."""
    dev = attrs.device
    lane = torch.arange(K, device=dev)
    s = start[tiles]
    live = lane[None, :] < (start[tiles + 1] - s)[:, None]
    idx = torch.where(live, s[:, None] + lane, 0)
    A = attrs[gid[idx]] * live[..., None].to(attrs.dtype)      # [G, K, 9]
    sub = torch.arange(PIX, device=dev)
    px = ((tiles % tiles_x)[:, None] * TILE + sub % TILE).to(attrs.dtype)
    py = ((tiles // tiles_x)[:, None] * TILE + sub // TILE).to(attrs.dtype)
    dx = A[:, None, :, 0] - px[..., None]
    dy = A[:, None, :, 1] - py[..., None]
    power = -0.5 * (A[:, None, :, 2] * dx * dx + A[:, None, :, 4] * dy * dy) \
        - A[:, None, :, 3] * dx * dy
    alpha = torch.clamp(A[:, None, :, 5] * torch.exp(power), max=ALPHA_MAX)
    ok = (power <= 0) & (alpha >= ALPHA_MIN) & live[:, None, :]
    return A, torch.where(ok, alpha, torch.zeros_like(alpha)), ok


def walk(alpha, ok):
    """Front to back: (transmittance before each entry, contributing)."""
    one_m = 1.0 - alpha
    T = torch.cumprod(one_m, -1)
    before = torch.cat([torch.ones_like(T[..., :1]), T[..., :-1]], -1)
    return before, ok & ((before * one_m).detach() >= T_EPS)


def blend_group(attrs, gid, start, tiles, K: int, tiles_x: int):
    """Blend one tile group. Returns (colour [G, PIX, 3], final
    transmittance [G, PIX])."""
    A, alpha, ok = group_alpha(attrs, gid, start, tiles, K, tiles_x)
    before, contrib = walk(alpha, ok)
    w = torch.where(contrib, alpha * before, torch.zeros_like(alpha))
    colour = w @ A[..., 6:9]
    final_T = torch.where(contrib, 1.0 - alpha,
                          torch.ones_like(alpha)).prod(-1)
    return colour, final_T


def tiles_to_image(x, tiles, tiles_x: int, tiles_y: int, channels: int):
    img = x.new_zeros(tiles_x * tiles_y, PIX, channels)
    img[tiles] = x
    img = img.reshape(tiles_y, tiles_x, TILE, TILE, channels)
    return img.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE,
                                              channels)


def image_to_tiles(img, tiles, tiles_x: int, tiles_y: int):
    c = img.shape[-1]
    t = img.reshape(tiles_y, TILE, tiles_x, TILE, c).permute(0, 2, 1, 3, 4)
    return t.reshape(tiles_x * tiles_y, PIX, c)[tiles]


def screen_attrs(proj):
    return torch.cat([proj["mean2d"], proj["conic"],
                      proj["opacity"][:, None], proj["color"]], 1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def ssim(img, gt, window: int = 11, sigma: float = 1.5):
    g = torch.exp(-(torch.arange(window, dtype=torch.float64) - window // 2)
                  ** 2 / (2 * sigma ** 2))
    g = g / g.sum()
    w2 = (g[:, None] * g[None, :]).to(img.dtype).to(img.device)
    x = torch.stack([img, gt, img * img, gt * gt, img * gt]).permute(
        0, 3, 1, 2).reshape(1, -1, img.shape[0], img.shape[1])
    k = w2.expand(x.shape[1], 1, window, window)
    mu1, mu2, e11, e22, e12 = F.conv2d(x, k, padding=window // 2,
                                       groups=x.shape[1]).reshape(
        5, 3, img.shape[0], img.shape[1])
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)
    return (num / den).mean()


def image_loss(img, gt, lambda_dssim: float = 0.2):
    return (1 - lambda_dssim) * (img - gt).abs().mean() \
        + lambda_dssim * (1 - ssim(img, gt))


# ---------------------------------------------------------------------------
# a step
# ---------------------------------------------------------------------------

def blend_backward(attrs, proj, blend, gt, width: int, height: int, bg,
                   lambda_dssim: float):
    """Blend the screen attributes `attrs` of the binned `proj` tile group by
    tile group with `blend` (blend_group's signature), take the image loss,
    and push its gradient back through each group. Returns (loss, image,
    the loss's gradient with respect to attrs)."""
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    gid, start = bin_tiles(proj, tiles_x, tiles_y)
    groups = tile_groups(start)
    a0 = attrs.detach()
    n_tiles = tiles_x * tiles_y
    with torch.no_grad():
        colour = torch.zeros(n_tiles, PIX, 3, dtype=a0.dtype,
                             device=a0.device)
        final_T = torch.ones(n_tiles, PIX, dtype=a0.dtype, device=a0.device)
        for tiles, K in groups:
            colour[tiles], final_T[tiles] = blend(a0, gid, start, tiles, K,
                                                  tiles_x)
        image = tiles_to_image(colour + final_T[..., None] * bg,
                               torch.arange(n_tiles, device=a0.device),
                               tiles_x, tiles_y, 3)
    img = image[:height, :width].detach().requires_grad_(True)
    loss = image_loss(img, gt, lambda_dssim)
    (d_img,) = torch.autograd.grad(loss, img)
    d_full = torch.zeros_like(image)
    d_full[:height, :width] = d_img
    a1 = a0.clone().requires_grad_(True)
    for tiles, K in groups:
        c, t = blend(a1, gid, start, tiles, K, tiles_x)
        cot = image_to_tiles(d_full, tiles, tiles_x, tiles_y)
        torch.autograd.backward([c, t], [cot, (cot * bg).sum(-1)])
    return loss.detach(), image, a1.grad


def render_and_grad(params, cam, gt, sh_degree: int, active, width: int,
                    height: int, bg, lambda_dssim: float = 0.2):
    """(loss, image, gradients of the loss w.r.t. every leaf of params)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    proj = project(leaves, cam, sh_degree, active, width, height)
    attrs = screen_attrs(proj)
    loss, image, d_attrs = blend_backward(attrs, proj, blend_group, gt,
                                          width, height, bg, lambda_dssim)
    grads = torch.autograd.grad(attrs, [leaves[k] for k in params],
                                grad_outputs=d_attrs, allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(params, grads)}
    return loss, image, grads


def learning_rates(step: int, extent: float, st: dict) -> Dict[str, float]:
    """The reference trainer's rates; the position's decays exponentially
    from its initial to its final rate (both times the scene extent) over
    position_lr_max_steps."""
    t = min(max(step / st["gaussians.position_lr_max_steps"], 0.0), 1.0)
    xyz = extent * math.exp(
        math.log(st["gaussians.position_lr_init"]) * (1 - t)
        + math.log(st["gaussians.position_lr_final"]) * t)
    feat = st["gaussians.feature_lr"]
    return {"xyz": xyz, "f_dc": feat, "f_rest": feat / 20.0,
            "scaling": st["gaussians.scaling_lr"],
            "rotation": st["gaussians.rotation_lr"],
            "opacity": st["gaussians.opacity_lr"]}


def adam(params, grads, m, v, count: int, lrs, b1=0.9, b2=0.999,
         eps=1e-15):
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    out = {}
    for k, p in params.items():
        m[k] = b1 * m[k] + (1 - b1) * grads[k]
        v[k] = b2 * v[k] + (1 - b2) * grads[k] * grads[k]
        out[k] = p - lrs[k] * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
    return out


def train_steps(params: Dict[str, torch.Tensor], cams, gts, first_step: int,
                st: dict, extent: float, active, width: int, height: int,
                bg) -> dict:
    """Train len(cams) steps from `params` (Adam's moments at zero), step
    first_step + i on cams[i] against gts[i]. Returns the losses, the first
    step's gradients and the parameters after the last step."""
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for i, (cam, gt) in enumerate(zip(cams, gts)):
        step = first_step + i
        deg = min(step // st["gaussians.oneup_sh_interval"],
                  st["gaussians.max_sh_degree"])
        loss, _, grads = render_and_grad(params, cam, gt, deg, active, width,
                                         height, bg, st["lambda_dssim"])
        losses.append(float(loss))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            params = adam(params, grads, m, v, i + 1,
                          learning_rates(step, extent, st))
    return {"losses": losses, "grads": first, "params": params}


@torch.no_grad()
def screen_pair_counts(attrs, gid, start, tiles_x: int, alpha_of=None):
    """(contributing pairs, instances holding one) of a binned render;
    alpha_of is group_alpha's signature (default: the gaussians')."""
    pairs = inst = 0
    for tiles, K in tile_groups(start):
        _, alpha, ok = (alpha_of or group_alpha)(attrs, gid, start, tiles, K,
                                                 tiles_x)
        contrib = walk(alpha, ok)[1]
        pairs += int(contrib.sum())
        inst += int(contrib.any(1).sum())
    return pairs, inst


@torch.no_grad()
def pair_counts(params, cam, sh_degree: int, active, width: int, height: int):
    """The blend's work on one render: (contributing pairs, instances,
    visible gaussians). A contributing pair is a (pixel, gaussian) pair with
    a blend weight, an instance a (tile, gaussian) pair that holds one; no
    other pair or instance adds anything to the image, so no blend needs to
    do more than these."""
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    proj = project(params, cam, sh_degree, active, width, height)
    gid, start = bin_tiles(proj, tiles_x, tiles_y)
    pairs, inst = screen_pair_counts(screen_attrs(proj), gid, start, tiles_x)
    return pairs, inst, int(proj["visible"].sum())


def leaf_norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


# ---------------------------------------------------------------------------
# the harness's interface (portbench/harness.py)
# ---------------------------------------------------------------------------

def configure():
    """Full float32 everywhere: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def program_params(state) -> Dict[str, torch.Tensor]:
    """The program's parameters, copied to the host."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in state.params.items()}


def program_step_state(state) -> Dict[str, torch.Tensor]:
    """Adam's first moments after the program's first step, on the host."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in state.adam_m.items()}


def _schedule(cell):
    st = cell.settings
    return (st["gaussians.oneup_sh_interval"], st["gaussians.max_sh_degree"])


def reference_steps(cell, scene, before, cameras, device, dtype) -> dict:
    """This file's three steps from `before` on the named cameras."""
    cams = [scene.camera(n) for n in cameras]
    gts = [torch.as_tensor(scene.image(c), device=device).to(dtype)
           for c in cams]
    params = {k: v.to(device).to(dtype) for k, v in before.items()}
    active = torch.arange(cell.capacity, device=device) < cell.points
    bg = torch.zeros(3, device=device, dtype=dtype)
    return train_steps(params, [camera_tensors(c, device, dtype)
                                for c in cams], gts, cell.start_step + 1,
                       cell.settings, scene_extent(scene.cams), active,
                       scene.width, scene.height, bg)


def compare(prog: dict, ref: dict, before, device,
            per_leaf: Optional[dict] = None) -> Dict[str, float]:
    """The numbers the check compares (each a gap that a sound run keeps
    small): the largest relative gap between the losses of a step; over
    the leaves, the largest gap between the norms of the first gradient,
    and of the parameters' change over the steps, against the reference's
    norm of that leaf or of the median leaf, whichever is larger. A leaf
    whose reference gradient is under a thousandth of the median leaf's
    (a zero gradient: SH bands not yet active) moves by round-off alone
    under Adam and is left out of the change."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                       ref["losses"]))
    g_ref, g_prog = leaf_norms(ref["grads"]), leaf_norms(prog["grads"])
    med = sorted(g_ref.values())[len(g_ref) // 2]
    grad_gap = max(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med)
                   for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med]

    def change(params):
        return {k: float(torch.linalg.norm(
            params[k].to(device).double() - before[k].to(device).double()))
            for k in moved}
    d_ref, d_prog = change(ref["params"]), change(prog["params"])
    med_d = sorted(d_ref.values())[len(d_ref) // 2]
    change_gap = max(abs(d_prog[k] - d_ref[k]) / max(d_ref[k], med_d)
                     for k in moved)
    if per_leaf is not None:
        per_leaf.update({k: {"grad": g_ref[k], "grad_gap": abs(
            g_prog[k] - g_ref[k]) / max(g_ref[k], med)} for k in g_ref})
        for k in moved:
            per_leaf[k].update(change=d_ref[k], change_gap=abs(
                d_prog[k] - d_ref[k]) / max(d_ref[k], med_d))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def start_gap(cell, scene, before, device, seed: int, sample: int = 2048,
              chunk: int = 128) -> float:
    """The largest absolute gap between `before` and the model this file
    makes from the scene's points: every leaf in full but the scales, which
    are checked on `sample` rows drawn from the seed (brute-force 3 nearest
    neighbours) and as -10 on the empty slots."""
    xyz, rgb = scene.points()
    ref = initial_leaves(xyz, rgb, cell.capacity,
                         cell.settings["gaussians.max_sh_degree"])
    gap = 0.0
    for k, v in ref.items():
        want = torch.as_tensor(v).double()
        gap = max(gap, float((before[k].double() - want).abs().max()))
    n = len(xyz)
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randperm(n, generator=gen)[:sample].to(device)
    pts = torch.as_tensor(xyz, device=device)
    want = torch.cat([knn_scale(pts, rows[i:i + chunk])
                      for i in range(0, len(rows), chunk)])
    got = before["scaling"].to(device)[rows].double()
    gap = max(gap, float((got - want.double()[:, None]).abs().max()))
    empty = before["scaling"][n:].double()
    if len(empty):
        gap = max(gap, float((empty + 10.0).abs().max()))
    return gap


def program_side(steps) -> dict:
    return {"losses": steps.losses,
            "grads": {k: m / 0.1 for k, m in steps.after1.items()},
            "params": steps.after3}


def readings(cell, scene, steps, device, seed: int,
             per_leaf: Optional[dict] = None) -> Dict[str, float]:
    """The program's numbers: its steps against this file's."""
    ref = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          torch.float32)
    nums = compare(program_side(steps), ref, steps.before, device, per_leaf)
    nums["start_gap"] = start_gap(cell, scene, steps.before, device, seed)
    return nums


def control_readings(cell, scene, steps, device, seed: int,
                     dtype=torch.bfloat16) -> Dict[str, float]:
    """The control's numbers: this file in `dtype` put in the program's
    place, from the same start on the same cameras."""
    ref = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          torch.float32)
    low = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          dtype)
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


def work(cell, scene, params, cameras, device, samples: int = 2) -> dict:
    """The work of the traced steps, from `params` (the model at the
    window's start) on the first `samples` of their cameras: the blend's
    least operations and bytes, and the step's (portbench/counts.py)."""
    from portbench import counts
    interval, max_deg = _schedule(cell)
    p = {k: v.to(device) for k, v in params.items()}
    active = torch.arange(cell.capacity, device=device) < cell.points
    first = cell.start_step + 3 + cell.warmup_steps + 1
    deg = min(first // interval, max_deg)
    rows = []
    for name in cameras[:samples]:
        cam = camera_tensors(scene.camera(name), device)
        pairs, inst, visible = pair_counts(p, cam, deg, active, scene.width,
                                           scene.height)
        rows.append(counts.vanilla_step(pairs, inst, visible, cell.capacity,
                                        scene.width, scene.height))
    return {k: {q: sum(r[k][q] for r in rows) / len(rows)
                for q in rows[0][k]} for k in rows[0]}
