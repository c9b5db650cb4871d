"""Plain PyTorch Octree-GS with PGSR planar splats: the yardstick the
octree-pgsr cells' training steps are held against.

Written from the methods (Ren et al. 2024, "Octree-GS"; Lu et al. 2024,
"Scaffold-GS"; Chen et al. 2024, "PGSR") and the rules the program states,
in plain tensor operations with autograd for every gradient; it imports
nothing of the program. It is composed of the two references beside it:

* from portbench/reference/octree2dgs.py: the octree layout and the start,
  the anchor prefilter and its level-of-detail mask, the Scaffold-GS decode
  of each visible anchor's n_offsets neural gaussians (view-dependent
  through the camera's position), the anchors' and heads' learning rates;
* from portbench/reference/pgsr.py: the planar blend and its maps, the
  plane depth, the neighbour lists and draw, the NCC sample and the normal,
  geo and NCC terms.

What this file adds: the planar render of decoded gaussians. Their scales
and opacities are the decode's (activated), their colours precomputed, and
a neural gaussian whose opacity is not positive is not drawn; each takes
the EWA projection of gs3d.py and the plane of pgsr.py (the normal the
axis of its smallest decoded scale, flipped to face the camera). A step
decodes and renders its camera and, past `multi_view_from`, a drawn
neighbour, each with its own prefilter, level mask and decode; the loss is
pgsr.py's terms of the two renders plus lambda_scaling times the mean, over
the reference camera's drawn neural gaussians, of the product of their
three scales; one backward runs through both decodes into the anchors and
the MLP, and Adam updates both.

Departures from GS-SR's octree_pgsr_scene.py, each where the program
states the rule: pgsr.py's (the plane-depth normal's sign, the
eps-safe normalisations and reprojection error, bilinear samples with
border clamp, the NCC over every pixel masked afterwards); the neighbour's
render has no observe count and feeds no anchor statistic (anchor growth
is off in the cells); the appearance embedding is not used (the preset's
appearance_dim is 0).

The check (judge): loss_gap and grad_gap are read on the first step alone
(first_step: its loss, and the share of anchors whose gradient row is
wrong), change_gap over the three steps and start_gap as
octree2dgs.py's.

`dtype` sets the precision of everything (the control runs bfloat16).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import gs3d, octree2dgs, pgsr
from portbench.reference.gs3d import (
    DILATE,
    NEAR,
    PIX,
    TILE,
    compare,
    configure,
)
from portbench.reference.octree2dgs import (
    ANCHOR_LEAVES,
    program_params,
    program_side,
    program_step_state,
    start_gap,
)

__all__ = ["configure", "compare", "program_params", "program_step_state"]

HEADS = ("op", "cov", "col")
# first_step's row check: an anchor's first gradient row is wrong where it
# is off by more than ROW_TOL of the larger of its norm and ROW_FLOOR times
# the leaf's median row
ROW_TOL = 0.1
ROW_FLOOR = 0.01
# the projection, covariance and plane of a drawn planar gaussian, forward
# (~300) and backward (twice that), its colour precomputed by the decode
NEURAL_OPS = 900


# ---------------------------------------------------------------------------
# a render of decoded gaussians
# ---------------------------------------------------------------------------

def project_neural(ng, cam, width: int, height: int) -> dict:
    """gs3d.project for decoded gaussians: their scales and opacities as
    decoded, their colours precomputed; a gaussian outside the decode's
    positive-opacity mask is not drawn."""
    xyz, scale, op = ng["xyz"], ng["scale"], ng["opacity"]
    R = gs3d.rotation_matrices(ng["rotation"])
    M = R * scale[:, None, :]
    cov3 = M @ M.transpose(1, 2)

    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], 1)
    p_view = hom @ cam["w2c"][:3, :].T
    p_hom = hom @ cam["full_proj"].T
    p_proj = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    depth = p_view[:, 2]
    front = (depth > NEAR) & ng["mask"]
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
    return dict(mean2d=mean2d, conic=conic, opacity=op, color=ng["color"],
                depth=depth.detach(), visible=visible, rect=rect)


def neural_planar_attrs(ng, cam, width: int, height: int):
    """(the projection, the planar screen attributes [N, 13]) of decoded
    gaussians: pgsr.planar_attrs with project_neural in gs3d.project's
    place."""
    proj = project_neural(ng, cam, width, height)
    xyz = ng["xyz"]
    R = gs3d.rotation_matrices(ng["rotation"])
    axis = torch.argmin(ng["scale"].detach(), -1)
    n = torch.gather(R, 2, axis[:, None, None].expand(-1, 3, 1))[..., 0]
    away = ((cam["campos"] - xyz) * n).sum(-1) < 0
    n = torch.where(away[:, None], -n, n)
    Rw, tw = cam["w2c"][:3, :3], cam["w2c"][:3, 3]
    n_cam = n @ Rw.T
    dist = (n_cam * (xyz @ Rw.T + tw)).sum(-1).abs()
    return proj, torch.cat([gs3d.screen_attrs(proj), n_cam, dist[:, None]],
                           1)


class NeuralRender(pgsr.Render):
    """pgsr.Render of decoded gaussians: its attributes (in autograd),
    binning and padded maps [H_pad, W_pad, 8]; attr_grad is pgsr.Render's."""

    def __init__(self, ng, cam, width: int, height: int):
        self.cam = cam
        self.tiles_x, self.tiles_y = -(-width // TILE), -(-height // TILE)
        proj, self.attrs = neural_planar_attrs(ng, cam, width, height)
        self.gid, self.start = gs3d.bin_tiles(proj, self.tiles_x,
                                              self.tiles_y)
        self.groups = gs3d.tile_groups(self.start)
        n_tiles = self.tiles_x * self.tiles_y
        a0 = self.attrs.detach()
        with torch.no_grad():
            out = torch.zeros(n_tiles, PIX, pgsr.MAPS, dtype=a0.dtype,
                              device=a0.device)
            out[..., pgsr.CHANNELS] = 1.0
            for tiles, K in self.groups:
                ch, t = pgsr.blend_group(a0, self.gid, self.start, tiles, K,
                                         self.tiles_x)
                out[tiles] = torch.cat([ch, t[..., None]], -1)
            self.maps = gs3d.tiles_to_image(
                out, torch.arange(n_tiles, device=a0.device), self.tiles_x,
                self.tiles_y, pgsr.MAPS)


def scaling_loss(ng, weight: float):
    """weight times the mean, over the drawn neural gaussians, of the
    product of their three scales."""
    s = ng["scale"]
    s = torch.where(ng["mask"], s[:, 0] * s[:, 1] * s[:, 2],
                    torch.zeros_like(ng["opacity"])).sum()
    return weight * s / torch.clamp(ng["mask"].sum().to(s.dtype), min=1.0)


# ---------------------------------------------------------------------------
# a step
# ---------------------------------------------------------------------------

def step_grads(state, views: List[tuple], gt, near_gt, layout, st: dict,
               width: int, height: int, bg, idx):
    """(the terms, the gradients of their sum w.r.t. every anchor and MLP
    leaf) of one step; views holds (camera, its index in the training
    order) of the step's camera and, on a two-camera step, its
    neighbour's."""
    anchors = {k: v.detach().requires_grad_(True)
               for k, v in state["anchors"].items()}
    mlp = {k: v.detach().requires_grad_(True)
           for k, v in state["mlp"].items()}
    renders, decoded = [], []
    for cam, index in views:
        vis = octree2dgs.visible_anchors(state, cam, layout, st, width,
                                         height)
        decoded.append(octree2dgs.decode(anchors, mlp, vis, cam["campos"],
                                         index, st))
        renders.append(NeuralRender(decoded[-1], cam, width, height))
    padded = [r.maps.detach().requires_grad_(True) for r in renders]
    maps = [pgsr.maps_of(p, r.cam, width, height, bg)
            for p, r in zip(padded, renders)]
    near_cam = views[1][0] if len(views) > 1 else None
    terms = pgsr.loss_terms(maps[0], maps[1] if near_cam is not None
                            else None, gt, near_gt, views[0][0], near_cam,
                            st, idx)
    cots = torch.autograd.grad(sum(terms.values()), padded)
    reg = scaling_loss(decoded[0], st["lambda_scaling"])
    leaves = [anchors[k] for k in ANCHOR_LEAVES] + list(mlp.values())
    got = torch.autograd.grad(
        [r.attrs for r in renders] + [reg], leaves,
        grad_outputs=[r.attr_grad(c) for r, c in zip(renders, cots)]
        + [torch.ones_like(reg)], allow_unused=True)
    grads = {k: torch.zeros_like(x) if g is None else g
             for k, x, g in zip(list(ANCHOR_LEAVES) + list(mlp), leaves,
                                got)}
    terms["scaling_loss"] = reg
    return {k: v.detach() for k, v in terms.items()}, grads


class Steps(pgsr.Steps):
    """pgsr.Steps over the anchors: its cameras, targets, neighbour lists
    and the process's count of two-camera steps, with the octree layout."""

    def __init__(self, cell, scene, seed: int, device, dtype):
        super().__init__(cell, scene, seed, device, dtype)
        self.layout = octree2dgs._layout(cell, scene)
        self.order = [c.name for c in scene.train_order()]

    def step(self, state, name: str, step: int, k: int):
        """(terms, gradients, the neighbour's name or None) of `step` on the
        camera `name`, k the process's count of two-camera steps before
        it."""
        cam, gt = self.camera(name)
        views = [(cam, self.order.index(name))]
        near_name, near_gt = None, None
        if self.multi_view(step):
            near_name = self.neighbour(name, k)
            near_cam, near_gt = self.camera(near_name)
            views.append((near_cam, self.order.index(near_name)))
        W, H = self.scene.width, self.scene.height
        idx = pgsr.ncc_sample(W * H, self.st, self.seed, step, self.device)
        terms, grads = step_grads(state, views, gt, near_gt, self.layout,
                                  self.st, W, H, self.bg, idx)
        return terms, grads, near_name

    def train(self, state, cameras: List[str], first_step: int,
              k: int = 0) -> dict:
        """Train on `cameras` from `state` (Adam's moments at zero), step
        first_step + i on cameras[i]. Returns the losses, each step's terms,
        the first step's gradients and the parameters after the last
        step."""
        extent = gs3d.scene_extent(self.scene.cams)
        params = {**state["anchors"], **state["mlp"]}
        m = {k_: torch.zeros_like(p) for k_, p in params.items()}
        v = {k_: torch.zeros_like(p) for k_, p in params.items()}
        losses, terms_all, first = [], [], None
        for i, name in enumerate(cameras):
            step = first_step + i
            terms, grads, near = self.step(state, name, step, k)
            k += near is not None
            terms_all.append({t: float(x) for t, x in terms.items()})
            losses.append(float(sum(terms.values())))
            if first is None:
                first = {k_: g.detach().clone() for k_, g in grads.items()}
            with torch.no_grad():
                params = gs3d.adam(params, grads, m, v, i + 1,
                                   octree2dgs.learning_rates(step, extent,
                                                             self.st))
            state = {**state,
                     "anchors": {k_: params[k_] for k_ in state["anchors"]},
                     "mlp": {k_: params[k_] for k_ in state["mlp"]}}
        return {"losses": losses, "terms": terms_all, "grads": first,
                "params": params}


# ---------------------------------------------------------------------------
# the harness's interface (portbench/harness.py)
# ---------------------------------------------------------------------------

def reference_steps(cell, scene, before, cameras, device, dtype,
                    seed: int) -> dict:
    """This file's three steps from `before` on the named cameras, the
    process's first two-camera steps."""
    return Steps(cell, scene, seed, device, dtype).train(
        octree2dgs._state(before, device, dtype), list(cameras),
        cell.start_step + 1)


def first_step(side: dict, ref: dict) -> Dict[str, float]:
    """This cell's loss_gap and grad_gap, both of the first step, which the
    two sides take from the same parameters: loss_gap, the relative gap of
    its loss; grad_gap, over the anchor leaves, the largest share of the
    anchors with a gradient (on either side) whose first gradient row is
    wrong (off by more than ROW_TOL of the larger of its norm and ROW_FLOOR
    times the leaf's median row). compare's loss and gradient norms over
    the three steps cannot hold this step: a pixel that rounding moves
    across the geo term's mask beside a near-singular texel of the plane
    depth can carry most of a leaf's gradient norm, and Adam's first update
    makes such a flip a full-size step. That pixel moves the loss by its own
    weight and the rows of the few anchors drawn there; leaving out part of
    the image, or a decode, moves the loss by that part's share and the rows
    of every anchor it reached."""
    loss_gap = abs(side["losses"][0] - ref["losses"][0]) \
        / abs(ref["losses"][0])
    share = 0.0
    for k in ANCHOR_LEAVES:
        r = ref["grads"][k].double().flatten(1)
        p = side["grads"][k].to(r.device).double().flatten(1)
        rn = torch.linalg.norm(r, dim=1)
        rows = (rn > 0) | (torch.linalg.norm(p, dim=1) > 0)
        if not bool(rows.any()):
            continue
        floor = ROW_FLOOR * rn[rows].median()
        wrong = torch.linalg.norm(p - r, dim=1) \
            > ROW_TOL * torch.clamp(rn, min=float(floor))
        share = max(share, float(wrong[rows].double().mean()))
    return {"loss_gap": loss_gap, "grad_gap": share}


def readings(cell, scene, steps, device, seed: int,
             per_leaf: Optional[dict] = None) -> Dict[str, float]:
    """The program's numbers: its steps against this file's (compare's
    change_gap over the three steps; loss_gap and grad_gap of the first,
    first_step)."""
    ref = reference_steps(cell, scene, steps.before, steps.cameras, device,
                          torch.float32, seed)
    side = program_side(steps)
    nums = compare(side, ref, octree2dgs._leaves(steps.before), device,
                   per_leaf)
    nums.update(first_step(side, ref))
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
    nums = compare(side, ref, octree2dgs._leaves(steps.before), device)
    nums.update(first_step(side, ref))
    own = {k: v.to(dtype).to(v.dtype) if v.is_floating_point() else v
           for k, v in steps.before.items()}
    nums["start_gap"] = start_gap(cell, scene, own, device, seed)
    return nums


def judge(cell, scene, steps, device, seed: int) -> dict:
    """Each number compared, beside its limit (the cell's `limits`)."""
    nums = readings(cell, scene, steps, device, seed)
    return {k: {"value": v, "limit": cell.limits[k]}
            for k, v in nums.items()}


def head_macs(mlp: Dict[str, torch.Tensor], st: dict) -> int:
    """Multiply-adds of one anchor's decode: the opacity, covariance and
    colour heads' two layers (models/scaffold.py::init_mlp's shapes), and
    the feature bank's with use_feat_bank."""
    heads = HEADS + (("fb",) if st["gaussians.use_feat_bank"] else ())
    return sum(mlp[f"{h}_w{j}"].numel() for h in heads for j in (1, 2))


def anchor_planar_step(renders: List[tuple], samples: int, capacity: int,
                       mlp_elements: int, macs: int, width: int,
                       height: int, st: dict) -> dict:
    """One octree-pgsr step's least work from each render's (contributing
    pairs, instances, drawn neural gaussians, visible anchors): the planar
    blend kernels' operations and bytes over the step's renders
    (pgsr.planar_step), and the whole step's operations: both blends, the
    image loss, each render's decode (forward and backward, 6 operations a
    multiply-add) and drawn gaussians, the multi-view terms on a two-camera
    step, and Adam over the anchor slots and the MLP."""
    from portbench import counts
    F, K = st["gaussians.feat_dim"], st["gaussians.n_offsets"]
    blend = pgsr.planar_step([r[:3] for r in renders], samples, capacity,
                             width, height)
    pixels = width * height
    anchor_elements = 3 + 3 * K + F + 6 + 4 + 1
    step = (blend["blend_pgsr_fwd"]["ops"] + blend["blend_pgsr_bwd"]["ops"]
            + counts.LOSS_OPS_PER_CHANNEL * 3 * pixels
            + sum(6 * macs * r[3] + NEURAL_OPS * r[2] for r in renders)
            + counts.ADAM_OPS_PER_ELEMENT * (anchor_elements * capacity
                                             + mlp_elements))
    if len(renders) > 1:
        step += (pgsr.NORMAL_PIXEL_OPS + pgsr.GEO_PIXEL_OPS) * pixels \
            + pgsr.NCC_SAMPLE_OPS * samples
    return {"blend_pgsr_fwd": blend["blend_pgsr_fwd"],
            "blend_pgsr_bwd": blend["blend_pgsr_bwd"], "step": {"ops": step}}


@torch.no_grad()
def render_counts(state, cam, index: int, layout, st: dict, width: int,
                  height: int) -> tuple:
    """(contributing pairs, instances, drawn neural gaussians, visible
    anchors) of one camera's decode and planar render."""
    vis = octree2dgs.visible_anchors(state, cam, layout, st, width, height)
    ng = octree2dgs.decode(state["anchors"], state["mlp"], vis,
                           cam["campos"], index, st)
    proj, attrs = neural_planar_attrs(ng, cam, width, height)
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    gid, start = gs3d.bin_tiles(proj, tiles_x, tiles_y)
    pairs, inst = gs3d.screen_pair_counts(attrs, gid, start, tiles_x)
    return pairs, inst, int(proj["visible"].sum()), len(vis)


def work(cell, scene, params, cameras, device, samples: int = 2) -> dict:
    """The work of the traced steps, from `params` (the model at the
    window's start) on the first `samples` of their cameras, each with a
    neighbour's decode and render past multi_view_from. The harness does
    not hand this function the run's seed, which draws the neighbour; so
    the neighbour counts as the mean of every training camera."""
    st = cell.settings
    state = octree2dgs._state(params, device, torch.float32)
    layout = octree2dgs._layout(cell, scene)
    order = [c.name for c in scene.train_order()]
    first = cell.start_step + 3 + cell.warmup_steps + 1
    names = list(cameras[:samples])
    multi = first > st["multi_view_from"]
    pool = order if multi else names
    seen = {n: render_counts(state, pgsr.camera_tensors(scene.camera(n),
                                                        device),
                             order.index(n), layout, st, scene.width,
                             scene.height)
            for n in dict.fromkeys(names + pool)}
    mean = tuple(sum(seen[n][j] for n in pool) / len(pool)
                 for j in range(4))
    mlp_elements = sum(v.numel() for v in state["mlp"].values())
    macs = head_macs(state["mlp"], st)
    rows = [anchor_planar_step(
        [seen[n]] + ([mean] if multi else []),
        min(st["num_sample"], scene.width * scene.height), cell.capacity,
        mlp_elements, macs, scene.width, scene.height, st) for n in names]
    return {k: {q: sum(r[k][q] for r in rows) / len(rows)
                for q in rows[0][k]} for k in rows[0]}
