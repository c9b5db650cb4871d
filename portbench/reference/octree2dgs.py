"""Plain PyTorch Octree-GS with 2DGS surfels: the yardstick the octree-2dgs
cells' training steps are held against.

Written from the methods (Ren et al. 2024, "Octree-GS"; Lu et al. 2024,
"Scaffold-GS"; Huang et al. 2024, "2D Gaussian Splatting") and the rules the
program states, in plain tensor operations with autograd for every
gradient; it imports nothing of the program. The projection, binning order,
blend walk, loss and Adam are portbench/reference/gs3d.py's; what differs:

* the start: anchors at the centres of one voxel grid per octree level (each
  level's voxel half the last's; the base voxel from the points' extent),
  levels from the training cameras' 0.999 / 0.001 distance quantiles, each
  position kept where the share of cameras whose rounded level reaches its
  level passes the mean share over all the grids' positions; scales from
  the 3-NN distance; the MLP heads
  drawn as torch.nn.Linear draws them;
* a step: the anchors whose 3-sigma footprint reaches a tile, narrowed by
  the camera's level-of-detail mask (level <= round(log2(standard distance /
  distance to the anchor's voxel centre)) + its learned bump); the Scaffold-
  GS decode of their n_offsets neural gaussians (opacity, covariance and
  colour heads on the feature and the view direction); those of positive
  opacity drawn as 2DGS surfels: the splat-to-pixel homogeneous map, the
  ray-splat intersection against the sqrt(2)/2 low-pass disk, each surfel
  over the tiles of the union box of its alpha >= 1/255 ellipse and that
  disk;
* the loss adds 0.01 times the mean over the drawn surfels of the product of
  their two scales (the 2DGS normal term starts at step 7000, the distortion
  term's weight is 0); Adam runs over the anchors and the MLP with the
  Scaffold-GS rates.

Only the colour image enters the loss before step 7000, so the surfel blend
here makes the colour and the transmittance, not the depth and normal maps.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference import gs3d
from portbench.reference.gs3d import (
    ALPHA_MAX,
    ALPHA_MIN,
    NEAR,
    PIX,
    TILE,
    compare,
    configure,
    walk,
)

__all__ = ["configure", "compare"]

FILTER_SIZE = 0.707106
CUTOFF = 3.0
OPACITY_INIT = math.log(0.1 / 0.9)
ANCHOR_LEAVES = ("anchor", "offset", "feat", "scaling", "rotation",
                 "opacity")
HEADS = ("op", "cov", "col", "fb")


# ---------------------------------------------------------------------------
# the start
# ---------------------------------------------------------------------------

def octree_layout(points: np.ndarray, centres: np.ndarray, st: dict) -> dict:
    """The octree's levels and anchor positions from the points (float64)
    and the camera centres."""
    fork, ratio = st["gaussians.fork"], st["gaussians.dist_ratio"]
    cams = np.concatenate([centres, np.ones((len(centres), 1))], 1)
    far = []
    for c in centres:
        d = np.linalg.norm(points - c, axis=1)
        far += [np.quantile(d, ratio), np.quantile(d, 1 - ratio)]
    far = np.asarray(far)
    dist_max, dist_min = np.quantile(far, ratio), np.quantile(far, 1 - ratio)
    levels = st["gaussians.levels"]
    if levels < 0:
        levels = int(round(math.log2(dist_max / dist_min)
                           / math.log2(fork))) + 1
    box_min = float(points.min()) * st["gaussians.extend"]
    box_d = float(points.max()) * st["gaussians.extend"] - box_min
    base = int(round(math.log2(box_d / 0.02))) - levels // 2 + 1
    voxel = box_d / float(fork) ** base
    origin = np.full(3, box_min, np.float32)
    pos, lv = [], []
    for level in range(levels):
        size = voxel / float(fork) ** level
        grid = np.unique(np.round((points - origin) / size), axis=0)
        pos.append(grid * size + origin)
        lv.append(np.full(len(grid), level, np.int32))
    pos, lv = np.concatenate(pos), np.concatenate(lv)

    def shares(p, l):
        count = np.zeros(len(p))
        for c in cams:
            d = np.linalg.norm(p - c[:3], axis=1) * c[3]
            pred = np.log2(dist_max / np.maximum(d, 1e-9)) / math.log2(fork)
            count += l <= np.clip(np.round(pred), 0, levels - 1)
        return count / len(cams)
    share = shares(pos, lv)
    threshold = float(share.mean())
    pos, lv = pos[share > 0.0], lv[share > 0.0]
    keep = shares(pos, lv) > threshold
    return {"positions": pos[keep], "levels": lv[keep], "n_levels": levels,
            "standard_dist": float(dist_max), "voxel": voxel}


def linear_heads(st: dict, num_cameras: int) -> Dict[str, torch.Tensor]:
    """The MLP as torch.nn.Linear initialises it (uniform within 1 /
    sqrt(fan_in)), weights [in, out], drawn in head order from a generator
    seeded 0; the appearance table zero."""
    F, K = st["gaussians.feat_dim"], st["gaussians.n_offsets"]
    A = st["gaussians.appearance_dim"]
    gen = torch.Generator().manual_seed(0)
    shapes = (("op", F + 3, F, K), ("cov", F + 3, F, 7 * K),
              ("col", F + 3 + A, F, 3 * K), ("fb", 4, F, 3))
    out = {}
    for name, fan_in, hidden, width in shapes:
        for j, (i, o) in enumerate(((fan_in, hidden), (hidden, width))):
            bound = 1.0 / math.sqrt(i)
            out[f"{name}_w{j + 1}"] = (torch.rand((i, o), generator=gen) * 2
                                       - 1) * bound
            out[f"{name}_b{j + 1}"] = (torch.rand((o,), generator=gen) * 2
                                       - 1) * bound
    out["appearance"] = torch.zeros((num_cameras, A)) if A > 0 \
        else torch.zeros((1, 0))
    return out


# ---------------------------------------------------------------------------
# a step
# ---------------------------------------------------------------------------

def prefilter(anchors, active, cam, width: int, height: int):
    """Anchors whose 3-sigma footprint (first three scales) covers a tile:
    gs3d.project of an opaque gaussian, whose alpha level set reaches past
    3 sigma."""
    p = {"xyz": anchors["anchor"], "scaling": anchors["scaling"][:, :3],
         "rotation": anchors["rotation"],
         "opacity": torch.full_like(anchors["anchor"][:, :1], 20.0),
         "f_dc": torch.zeros_like(anchors["anchor"][:, None]),
         "f_rest": anchors["anchor"].new_zeros(len(active), 0, 3)}
    return gs3d.project(p, cam, 0, active, width, height)["visible"]


def lod_mask(level, extra, anchors, campos, layout, st):
    """The anchors the camera's level of detail keeps."""
    fork = float(st["gaussians.fork"])
    lf = level.to(torch.float32)
    half = torch.tensor(layout["voxel"] / 2.0, dtype=torch.float32,
                        device=lf.device)
    pos = anchors["anchor"] + (half / torch.pow(
        torch.full_like(lf, fork), lf))[:, None]
    d = torch.linalg.norm(pos - campos, dim=-1)
    pred = torch.log2(torch.tensor(layout["standard_dist"],
                                   dtype=torch.float32, device=d.device)
                      / torch.clamp(d, min=1e-9)) \
        / torch.tensor(math.log2(fork), dtype=torch.float32, device=d.device)
    pred = pred + extra
    target = torch.clamp(torch.round(pred), 0, layout["n_levels"] - 1)
    return lf <= target


def decode(anchors, mlp, idx, campos, cam_index: int, st):
    """The neural gaussians of the anchors idx: xyz, colour, opacity
    (0 where the raw opacity is not positive), scales (3), rotations and
    the positive-opacity mask, [V K] rows in anchor order."""
    K = st["gaussians.n_offsets"]
    a = {k: v[idx] for k, v in anchors.items()}
    ob = a["anchor"] - campos
    dist = torch.linalg.norm(ob, dim=-1, keepdim=True)
    base = torch.cat([a["feat"], ob / (dist + 1e-12)], -1)

    def head(name, x):
        h = torch.relu(x @ mlp[f"{name}_w1"] + mlp[f"{name}_b1"])
        return h @ mlp[f"{name}_w2"] + mlp[f"{name}_b2"]
    op = torch.tanh(head("op", base))
    sr = head("cov", base).reshape(-1, K, 7)
    xc = base
    if st["gaussians.appearance_dim"] > 0:
        app = mlp["appearance"][cam_index]
        xc = torch.cat([base, app.expand(len(base), -1)], -1)
    col = torch.sigmoid(head("col", xc)).reshape(-1, K, 3)
    s = torch.exp(a["scaling"])
    scale = s[:, None, 3:6] * torch.sigmoid(sr[..., :3])
    rot = sr[..., 3:7]
    rot = rot / (torch.linalg.norm(rot, dim=-1, keepdim=True) + 1e-12)
    xyz = a["anchor"][:, None] + a["offset"] * s[:, None, :3]
    mask = op > 0
    return {"xyz": xyz.reshape(-1, 3), "color": col.reshape(-1, 3),
            "opacity": torch.where(mask, op, torch.zeros_like(op)).reshape(-1),
            "scale": scale.reshape(-1, 3), "rotation": rot.reshape(-1, 4),
            "mask": mask.reshape(-1)}


def _box(Tu, Tv, Tw, level, visible):
    """Centre and half extents of the image of the splat's {rho <= level^2}
    ellipse (its dual conic)."""
    l2 = level * level * torch.ones_like(Tw[:, 0])
    t = torch.stack([l2, l2, -torch.ones_like(l2)], -1)
    d = (t * Tw * Tw).sum(-1)
    visible = visible & (d != 0)
    f = t / torch.where(visible, d, torch.ones_like(d))[:, None]
    cx, cy = (f * Tu * Tw).sum(-1), (f * Tv * Tw).sum(-1)
    hx = torch.sqrt(torch.clamp(cx * cx - (f * Tu * Tu).sum(-1), min=1e-4))
    hy = torch.sqrt(torch.clamp(cy * cy - (f * Tv * Tv).sum(-1), min=1e-4))
    return cx, cy, hx, hy, visible


def project_surfels(ng, cam, width: int, height: int):
    """Per surfel: the screen attributes the blend reads (mean2d, the
    intersection's invariants Tu x Tv, Tw x Tv, Tu x Tw, Tw, opacity,
    colour; [N, 18]), depth, visible and the tile rect."""
    pad_w, pad_h = -(-width // TILE) * TILE, -(-height // TILE) * TILE
    xyz, op = ng["xyz"], ng["opacity"]
    R = gs3d.rotation_matrices(ng["rotation"])
    L0 = R[:, :, 0] * ng["scale"][:, 0:1]
    L1 = R[:, :, 1] * ng["scale"][:, 1:2]
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1)
    p_view = hom @ cam["w2c"][:3, :].T
    depth = p_view[:, 2]
    visible = (depth > NEAR) & ng["mask"]
    P = cam["full_proj"]
    A = torch.stack([0.5 * pad_w * P[0] + 0.5 * (pad_w - 1) * P[3],
                     0.5 * pad_h * P[1] + 0.5 * (pad_h - 1) * P[3], P[3]])
    cu, cv = L0 @ A[:, :3].T, L1 @ A[:, :3].T
    cw = xyz @ A[:, :3].T + A[:, 3]
    Tu = torch.stack([cu[:, 0], cv[:, 0], cw[:, 0]], -1)
    Tv = torch.stack([cu[:, 1], cv[:, 1], cw[:, 1]], -1)
    Tw = torch.stack([cu[:, 2], cv[:, 2], cw[:, 2]], -1)
    n_view = R[:, :, 2] @ cam["w2c"][:3, :3].T
    visible = visible & ((p_view * n_view).sum(-1) != 0)
    cx, cy, _, _, visible = _box(Tu, Tv, Tw, CUTOFF, visible)
    mean2d = torch.where(visible[:, None], torch.stack([cx, cy], -1),
                         torch.zeros_like(Tu[:, :2]))
    with torch.no_grad():
        opd = op.detach()
        visible = visible & (opd * 255.0 > 1.0)
        s = torch.clamp(torch.sqrt(2.0 * torch.log(torch.clamp(
            opd * 255.0, min=1.0 + 1e-6))), max=3.0)
        cxL, cyL, rx3, ry3, visible = _box(Tu.detach(), Tv.detach(),
                                           Tw.detach(), s, visible)
        c0x, c0y = cx.detach(), cy.detach()
        rlp = s * FILTER_SIZE
        bx0 = torch.minimum(cxL - rx3, c0x - rlp)
        bx1 = torch.maximum(cxL + rx3, c0x + rlp)
        by0 = torch.minimum(cyL - ry3, c0y - rlp)
        by1 = torch.maximum(cyL + ry3, c0y + rlp)
        mx, my = 0.5 * (bx0 + bx1), 0.5 * (by0 + by1)
        rx, ry = torch.ceil(0.5 * (bx1 - bx0)), torch.ceil(0.5 * (by1 - by0))
        tiles_x, tiles_y = pad_w // TILE, pad_h // TILE
        rect = torch.stack([
            torch.clamp(torch.floor((mx - rx) / TILE), 0, tiles_x),
            torch.clamp(torch.floor((my - ry) / TILE), 0, tiles_y),
            torch.clamp(torch.floor((mx + rx) / TILE) + 1, 0, tiles_x),
            torch.clamp(torch.floor((my + ry) / TILE) + 1, 0, tiles_y),
        ], 1)
        rect = torch.where(visible[:, None], rect, torch.zeros_like(rect))
        rect = rect.long()
        area = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
        visible = visible & (area > 0)
    attrs = torch.cat([mean2d, torch.linalg.cross(Tu, Tv),
                       torch.linalg.cross(Tw, Tv), torch.linalg.cross(Tu, Tw),
                       Tw, op[:, None], ng["color"]], 1)
    return {"attrs": attrs, "depth": depth.detach(), "visible": visible,
            "rect": rect}


def group_alpha(attrs, gid, start, tiles, K: int, tiles_x: int):
    """Surfel alpha of every (tile, pixel, list entry) of one tile group."""
    dev = attrs.device
    lane = torch.arange(K, device=dev)
    s = start[tiles]
    live = lane[None, :] < (start[tiles + 1] - s)[:, None]
    idx = torch.where(live, s[:, None] + lane, 0)
    A = attrs[gid[idx]] * live[..., None].to(attrs.dtype)       # [G, K, 18]
    sub = torch.arange(PIX, device=dev)
    px = ((tiles % tiles_x)[:, None] * TILE + sub % TILE).to(attrs.dtype)
    py = ((tiles // tiles_x)[:, None] * TILE + sub // TILE).to(attrs.dtype)
    px, py = px[..., None], py[..., None]

    def r(i):
        return A[:, None, :, i]
    p = [r(2 + j) - px * r(5 + j) - py * r(8 + j) for j in range(3)]
    pz_ok = p[2] != 0
    rpz = 1.0 / torch.where(pz_ok, p[2], torch.ones_like(p[2]))
    s0 = torch.clamp(p[0] * rpz, -1e4, 1e4)
    s1 = torch.clamp(p[1] * rpz, -1e4, 1e4)
    rho3d = s0 * s0 + s1 * s1
    dx, dy = r(0) - px, r(1) - py
    rho2d = 2.0 * (dx * dx + dy * dy)
    is3d = rho3d <= rho2d
    rho = torch.where(is3d, rho3d, rho2d)
    depth = torch.where(is3d, s0 * r(11) + s1 * r(12) + r(13),
                        r(13).expand_as(s0))
    alpha = torch.clamp(r(14) * torch.exp(-0.5 * rho), max=ALPHA_MAX)
    ok = pz_ok & (depth >= NEAR) & (alpha >= ALPHA_MIN) & live[:, None, :]
    return A, torch.where(ok, alpha, torch.zeros_like(alpha)), ok


def blend_group(attrs, gid, start, tiles, K: int, tiles_x: int):
    A, alpha, ok = group_alpha(attrs, gid, start, tiles, K, tiles_x)
    before, contrib = walk(alpha, ok)
    w = torch.where(contrib, alpha * before, torch.zeros_like(alpha))
    colour = w @ A[..., 15:18]
    final_T = torch.where(contrib, 1.0 - alpha,
                          torch.ones_like(alpha)).prod(-1)
    return colour, final_T


def scaling_loss(ng, weight: float):
    s = torch.where(ng["mask"], ng["scale"][:, 0] * ng["scale"][:, 1],
                    torch.zeros_like(ng["opacity"])).sum()
    return weight * s / torch.clamp(ng["mask"].sum().to(s.dtype), min=1.0)


def visible_anchors(state, cam, layout, st, width, height):
    with torch.no_grad():
        vis = prefilter(state["anchors"], state["active"], cam, width,
                        height)
        vis = vis & lod_mask(state["level"], state["extra_level"],
                             state["anchors"], cam["campos"], layout, st)
        return torch.nonzero(vis & state["active"]).flatten()


def render_and_grad(state, cam, cam_index: int, gt, layout, st, width: int,
                    height: int, bg):
    """(loss, gradients of every anchor and MLP leaf)."""
    anchors = {k: v.detach().requires_grad_(True)
               for k, v in state["anchors"].items()}
    mlp = {k: v.detach().requires_grad_(True)
           for k, v in state["mlp"].items()}
    idx = visible_anchors(state, cam, layout, st, width, height)
    ng = decode(anchors, mlp, idx, cam["campos"], cam_index, st)
    proj = project_surfels(ng, cam, width, height)
    attrs = proj["attrs"]
    loss, _, d_attrs = gs3d.blend_backward(attrs, proj, blend_group, gt,
                                           width, height, bg,
                                           st["lambda_dssim"])
    reg = scaling_loss(ng, st["lambda_scaling"])
    leaves = [anchors[k] for k in ANCHOR_LEAVES] + list(mlp.values())
    grads = torch.autograd.grad([attrs, reg], leaves,
                                grad_outputs=[d_attrs, torch.ones_like(reg)],
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    names = list(ANCHOR_LEAVES) + list(mlp)
    return loss + reg.detach(), dict(zip(names, grads))


def expon(step: int, init: float, final: float, max_steps: int) -> float:
    if init == 0.0 and final == 0.0:
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def learning_rates(step: int, extent: float, st: dict) -> Dict[str, float]:
    """Scaffold-GS's rates: anchor positions, rotations and opacities
    frozen; the offsets' and the heads' decaying exponentially over their
    max steps; the feature bank's only in use, the appearance table's only
    with appearance_dim."""
    g = {k[len("gaussians."):]: v for k, v in st.items()
         if k.startswith("gaussians.")}

    def e(name, scale=1.0):
        return expon(step, g[f"{name}_lr_init"] * scale,
                     g[f"{name}_lr_final"] * scale, g[f"{name}_lr_max_steps"])
    out = {"anchor": e("position", extent) if g["position_lr_init"] > 0
           else 0.0,
           "offset": e("offset", extent), "feat": g["feature_lr"],
           "scaling": g["scaling_lr"], "rotation": 0.0, "opacity": 0.0}
    heads = {"op": e("mlp_opacity"), "cov": e("mlp_cov"),
             "col": e("mlp_color"),
             "fb": e("mlp_featurebank") if g["use_feat_bank"] else 0.0}
    for h in HEADS:
        for p in ("w1", "b1", "w2", "b2"):
            out[f"{h}_{p}"] = heads[h]
    out["appearance"] = e("appearance") if g["appearance_dim"] > 0 else 0.0
    return out


def train_steps(state, cams, cam_indices, gts, first_step: int, layout,
                st, extent: float, width: int, height: int, bg) -> dict:
    params = {**state["anchors"], **state["mlp"]}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for i, (cam, ci, gt) in enumerate(zip(cams, cam_indices, gts)):
        step = first_step + i
        loss, grads = render_and_grad(state, cam, ci, gt, layout, st, width,
                                      height, bg)
        losses.append(float(loss))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            params = gs3d.adam(params, grads, m, v, i + 1,
                               learning_rates(step, extent, st))
        state = {**state,
                 "anchors": {k: params[k] for k in state["anchors"]},
                 "mlp": {k: params[k] for k in state["mlp"]}}
    return {"losses": losses, "grads": first, "params": params}


# ---------------------------------------------------------------------------
# the harness's interface (portbench/harness.py)
# ---------------------------------------------------------------------------

def program_params(state) -> Dict[str, torch.Tensor]:
    """The program's anchors, MLP, levels and active mask, on the host."""
    out = {k: v.detach().to("cpu", copy=True) for k, v in
           {**state.anchors, **state.mlp}.items()}
    out["level"] = state.level.detach().to("cpu", copy=True)
    out["extra_level"] = state.extra_level.detach().to("cpu", copy=True)
    out["active"] = state.active.detach().to("cpu", copy=True)
    return out


def program_step_state(state) -> Dict[str, torch.Tensor]:
    """Adam's first moments of every leaf after the program's first step."""
    return {k: v.detach().to("cpu", copy=True) for k, v in
            {**state.adam_anchor.m, **state.adam_mlp.m}.items()}


def _layout(cell, scene):
    xyz, _ = scene.points()
    centres = np.stack([gs3d.camera_tensors(c, "cpu")["centre"]
                        for c in scene.train_order()])
    return octree_layout(xyz.astype(np.float64), centres.astype(np.float64),
                         cell.settings)


def _state(before, device, dtype):
    mlp_keys = [k for k in before if k.split("_")[0] in HEADS
                or k == "appearance"]
    return {"anchors": {k: before[k].to(device).to(dtype)
                        for k in ANCHOR_LEAVES},
            "mlp": {k: before[k].to(device).to(dtype) for k in mlp_keys},
            "level": before["level"].to(device),
            "extra_level": before["extra_level"].to(device).to(dtype),
            "active": before["active"].to(device)}


def reference_steps(cell, scene, before, cameras, device, dtype) -> dict:
    layout = _layout(cell, scene)
    order = [c.name for c in scene.train_order()]
    cams = [scene.camera(n) for n in cameras]
    gts = [torch.as_tensor(scene.image(c), device=device).to(dtype)
           for c in cams]
    bg = torch.zeros(3, device=device, dtype=dtype)
    return train_steps(_state(before, device, dtype),
                       [gs3d.camera_tensors(c, device, dtype) for c in cams],
                       [order.index(n) for n in cameras], gts,
                       cell.start_step + 1, layout, cell.settings,
                       gs3d.scene_extent(scene.cams), scene.width,
                       scene.height, bg)


def _leaves(d):
    return {k: v for k, v in d.items()
            if k not in ("level", "extra_level", "active")}


def start_gap(cell, scene, before, device, seed: int, sample: int = 2048,
              chunk: int = 128) -> float:
    """The largest gap between `before` and the start this file makes: the
    anchor positions and levels, the zero offsets, features and level bumps,
    the anchors' identity rotations, the 0.1 opacities, the MLP draw, and the
    scales
    on `sample` anchors drawn from the seed (brute-force 3 nearest
    neighbours), -10 on the empty slots. A missing or extra anchor reads
    inf."""
    st = cell.settings
    lay = _layout(cell, scene)
    n = len(lay["positions"])
    if int(before["active"].sum()) != n or not bool(before["active"][:n].all()):
        return float("inf")
    want = {"anchor": torch.as_tensor(lay["positions"].astype(np.float32)),
            "level": torch.as_tensor(lay["levels"])}
    gap = 0.0
    for k, v in want.items():
        gap = max(gap, float((before[k][:n].double() - v.double()).abs()
                             .max()))
    for k, fill in (("offset", 0.0), ("feat", 0.0), ("extra_level", 0.0),
                    ("opacity", OPACITY_INIT)):
        gap = max(gap, float((before[k].double() - fill).abs().max()))
    rot = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    gap = max(gap, float((before["rotation"][:n].double() - rot).abs()
                         .max()))
    for k, v in linear_heads(st, len(scene.cams)).items():
        gap = max(gap, float((before[k].double() - v.double()).abs().max())
                  if v.numel() else 0.0)
    gen = torch.Generator().manual_seed(seed)
    rows = torch.randperm(n, generator=gen)[:sample].to(device)
    pts = torch.as_tensor(lay["positions"], device=device)
    near = torch.cat([gs3d.knn_scale(pts, rows[i:i + chunk])
                      for i in range(0, len(rows), chunk)])
    got = before["scaling"].to(device)[rows].double()
    gap = max(gap, float((got - near[:, None]).abs().max()))
    empty = before["scaling"][n:].double()
    if len(empty):
        gap = max(gap, float((empty + 10.0).abs().max()))
    return gap


def program_side(steps) -> dict:
    return {"losses": steps.losses,
            "grads": {k: m / 0.1 for k, m in steps.after1.items()},
            "params": _leaves(steps.after3)}


def readings(cell, scene, steps, device, seed: int,
             per_leaf: Optional[dict] = None) -> Dict[str, float]:
    ref = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          torch.float32)
    nums = compare(program_side(steps), ref, _leaves(steps.before), device,
                   per_leaf)
    nums["start_gap"] = start_gap(cell, scene, steps.before, device, seed)
    return nums


def control_readings(cell, scene, steps, device, seed: int,
                     dtype=torch.bfloat16) -> Dict[str, float]:
    ref = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          torch.float32)
    low = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          dtype)
    side = {"losses": low["losses"],
            "grads": {k: g.float() for k, g in low["grads"].items()},
            "params": {k: p.float() for k, p in low["params"].items()}}
    nums = compare(side, ref, _leaves(steps.before), device)
    own = {k: v.to(dtype).to(v.dtype) if v.is_floating_point() else v
           for k, v in steps.before.items()}
    nums["start_gap"] = start_gap(cell, scene, own, device, seed)
    return nums


def judge(cell, scene, steps, device, seed: int) -> dict:
    nums = readings(cell, scene, steps, device, seed)
    return {k: {"value": v, "limit": cell.limits[k]}
            for k, v in nums.items()}


@torch.no_grad()
def work(cell, scene, params, cameras, device, samples: int = 2) -> dict:
    """The work of the traced steps, from the model at the window's start on
    the first `samples` of their cameras (portbench/counts.py)."""
    from portbench import counts
    st = cell.settings
    state = _state(params, device, torch.float32)
    layout = _layout(cell, scene)
    order = [c.name for c in scene.train_order()]
    tiles_x = -(-scene.width // TILE)
    tiles_y = -(-scene.height // TILE)
    rows = []
    for name in cameras[:samples]:
        cam = gs3d.camera_tensors(scene.camera(name), device)
        idx = visible_anchors(state, cam, layout, st, scene.width,
                              scene.height)
        ng = decode(state["anchors"], state["mlp"], idx, cam["campos"],
                    order.index(name), st)
        proj = project_surfels(ng, cam, scene.width, scene.height)
        gid, start = gs3d.bin_tiles(proj, tiles_x, tiles_y)
        pairs, inst = gs3d.screen_pair_counts(proj["attrs"], gid, start,
                                              tiles_x, group_alpha)
        rows.append(counts.surfel_step(
            pairs, inst, len(idx), int(proj["visible"].sum()),
            int(state["active"].shape[0]), scene.width, scene.height, st))
    return {k: {q: sum(r[k][q] for r in rows) / len(rows)
                for q in rows[0][k]} for k in rows[0]}
