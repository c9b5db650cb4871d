"""Scaffold-GS: anchors and the per-anchor neural-gaussian MLP decode (port
of gssr_tpu/models/scaffold.py).

Same MLPs (feat -> feat -> K heads with tanh / linear / sigmoid), learning
rate schedules, statistics, multi-resolution anchor growing with voxel
dedup (ops/voxel.py) and opacity-accumulation pruning as the reference.
The anchors keep the reference's fixed-capacity layout with an `active`
mask, slot for slot. The decode runs on the visible anchors only, sized
exactly per step and in anchor-slot order, as ops/binning.py sizes its
instance buffer: the reference's static visible-anchor budget, its
overflow flag and its budget bump have no counterpart, and the live
neural gaussians come in the reference's compacted order. State is plain
dicts of tensors on one device; operations return new state.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from gssr_tpu_torch.models.vanilla import Adam, VanillaGaussians
from gssr_tpu_torch.ops.knn import mean_knn_dist2_host
from gssr_tpu_torch.ops.voxel import (
    KEY_MAX,
    dedup_against,
    hash_coords,
    segment_max_sorted,
    voxelize_points_host,
)
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.utils.general import expon_lr
from gssr_tpu_torch.utils.tracing import span

ANCHOR_NAMES = ("anchor", "offset", "feat", "scaling", "rotation", "opacity")
MLP_NAMES = ("op_w1", "op_b1", "op_w2", "op_b2", "cov_w1", "cov_b1",
             "cov_w2", "cov_b2", "col_w1", "col_b1", "col_w2", "col_b2",
             "fb_w1", "fb_b1", "fb_w2", "fb_b2", "appearance")
STAT_NAMES = ("opacity_accum", "anchor_denom", "offset_grad_accum",
              "offset_denom")
OPACITY_INIT = float(np.log(0.1 / 0.9))


@dataclasses.dataclass(frozen=True)
class ScaffoldGaussianConfig:
    max_sh_degree: int = 3          # unused (colours from the MLP)
    percent_dense: float = 0.01
    sampling_ratio: int = 1

    feat_dim: int = 32
    n_offsets: int = 10
    voxel_size: float = 0.001       # <= 0: the median 3-NN distance
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4

    start_stat: int = 500
    densification_interval: int = 100
    densify_from_iter: int = 1500
    densify_until_iter: int = 15_000
    success_threshold: float = 0.8
    densify_grad_threshold: float = 0.0002
    opacity_cull_threshold: float = 0.005

    use_feat_bank: bool = False
    appearance_dim: int = 32
    view_dim: int = 3
    add_opacity_dist: bool = False
    add_cov_dist: bool = False
    add_color_dist: bool = False

    position_lr_init: float = 0.0
    position_lr_final: float = 0.0
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0075
    opacity_lr: float = 0.02
    scaling_lr: float = 0.007
    rotation_lr: float = 0.002
    offset_lr_init: float = 0.01
    offset_lr_final: float = 0.0001
    offset_lr_delay_mult: float = 0.01
    offset_lr_max_steps: int = 30_000
    mlp_opacity_lr_init: float = 0.002
    mlp_opacity_lr_final: float = 0.00002
    mlp_opacity_lr_max_steps: int = 30_000
    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_final: float = 0.004
    mlp_cov_lr_max_steps: int = 30_000
    mlp_color_lr_init: float = 0.008
    mlp_color_lr_final: float = 0.00005
    mlp_color_lr_max_steps: int = 30_000
    mlp_featurebank_lr_init: float = 0.01
    mlp_featurebank_lr_final: float = 0.00001
    mlp_featurebank_lr_max_steps: int = 30_000
    appearance_lr_init: float = 0.05
    appearance_lr_final: float = 0.0005
    appearance_lr_max_steps: int = 30_000

    capacity: int = 0
    capacity_multiplier: float = 4.0


@dataclasses.dataclass
class ScaffoldState:
    """Anchors (anchor [CA,3], offset [CA,K,3], feat [CA,F], scaling
    [CA,6] log, rotation [CA,4] and opacity [CA,1], the last two frozen),
    the MLP (MLP_NAMES), Adam over each, the statistics (STAT_NAMES) and
    the active mask."""
    anchors: Dict[str, torch.Tensor]
    mlp: Dict[str, torch.Tensor]
    adam_anchor: Adam
    adam_mlp: Adam
    stats: Dict[str, torch.Tensor]
    active: torch.Tensor               # [CA] bool
    n_active: torch.Tensor             # [] int32


class NeuralGaussians(NamedTuple):
    """The decoded gaussians of the visible anchors, [V*K] rows in
    anchor-slot order (anchor_idx [V] the slots), with their mask."""
    xyz: torch.Tensor
    color: torch.Tensor
    opacity: torch.Tensor          # masked neural opacity (0 where off)
    scaling: torch.Tensor          # [V*K, 3] activated
    rotation: torch.Tensor         # [V*K, 4]
    mask: torch.Tensor             # [V*K] bool, neural opacity > 0
    neural_opacity: torch.Tensor   # [V*K] raw tanh output
    anchor_idx: torch.Tensor       # [V] int64 anchor slots


def _linear_init(gen, fan_in: int, fan_out: int):
    """torch.nn.Linear's default init, drawn from `gen`, stored [in, out]
    for h @ w (the reference's layout)."""
    bound = 1.0 / math.sqrt(fan_in)
    w = (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * bound
    b = (torch.rand((fan_out,), generator=gen) * 2 - 1) * bound
    return w, b


def reciprocal_f32(size: float, device) -> torch.Tensor:
    """1 / size rounded once to float32, as a device scalar. The reference's
    jitted densify divides by a voxel size that is a compile-time constant,
    which XLA turns into a multiply by this reciprocal (and PyTorch's CUDA
    division by a host scalar does the same); on a voxel grid x / size
    often lands exactly on a .5 tie of `round`, where the two differ."""
    return torch.tensor(np.float32(1.0) / np.float32(size), device=device)


def _where_new(newly, x, value):
    """x with the rows of the new anchor slots set to value."""
    nd = newly.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(nd, torch.as_tensor(value, dtype=x.dtype,
                                           device=x.device), x)


class ScaffoldGaussians:
    def __init__(self, config: ScaffoldGaussianConfig,
                 spatial_lr_scale: float = 1.0, num_cameras: int = 1):
        self.config = config
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.num_cameras = num_cameras
        self.voxel_size = config.voxel_size    # may be set at init

    @staticmethod
    def get_scaling(anchors):
        return torch.exp(anchors["scaling"])

    @staticmethod
    def get_rotation(anchors):
        r = anchors["rotation"]
        return r / (torch.linalg.norm(r, dim=-1, keepdim=True) + 1e-12)

    # ---------------- init --------------------------------------------
    def init_mlp(self, device, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The three heads, the feature bank and the appearance table, each
        Linear drawn as torch.nn.Linear draws it from a CPU generator
        seeded with `seed`."""
        cfg = self.config
        gen = torch.Generator().manual_seed(seed)
        F, K, vd, A = (cfg.feat_dim, cfg.n_offsets, cfg.view_dim,
                       cfg.appearance_dim)
        shapes = (("op", F + vd + int(cfg.add_opacity_dist), F, K),
                  ("cov", F + vd + int(cfg.add_cov_dist), F, 7 * K),
                  ("col", F + vd + int(cfg.add_color_dist) + A, F, 3 * K),
                  ("fb", vd + 1, F, 3))
        mlp = {}
        for name, fan_in, hidden, out in shapes:
            mlp[f"{name}_w1"], mlp[f"{name}_b1"] = _linear_init(gen, fan_in,
                                                                hidden)
            mlp[f"{name}_w2"], mlp[f"{name}_b2"] = _linear_init(gen, hidden,
                                                                out)
        mlp["appearance"] = (torch.zeros((self.num_cameras, A)) if A > 0
                             else torch.zeros((1, 0)))
        return {k: mlp[k].to(device) for k in MLP_NAMES}

    def _new_state(self, anchors, mlp, n: int) -> ScaffoldState:
        cap, K = anchors["offset"].shape[:2]
        dev = anchors["anchor"].device
        stats = {"opacity_accum": torch.zeros(cap, device=dev),
                 "anchor_denom": torch.zeros(cap, device=dev),
                 "offset_grad_accum": torch.zeros((cap, K), device=dev),
                 "offset_denom": torch.zeros((cap, K), device=dev)}
        return ScaffoldState(
            anchors=anchors, mlp=mlp, adam_anchor=Adam.zeros(anchors),
            adam_mlp=Adam.zeros(mlp), stats=stats,
            active=torch.arange(cap, device=dev) < n,
            n_active=torch.tensor(n, dtype=torch.int32, device=dev))

    def create_from_points(self, points: np.ndarray, colors=None,
                           device="cpu", capacity: Optional[int] = None,
                           seed: int = 0) -> ScaffoldState:
        """Anchors at the centres of the voxels that hold a point (float64
        on the host, as the reference), scales from the 3-NN distance, the
        MLP from init_mlp(seed). `colors` is not used."""
        cfg = self.config
        points = np.asarray(points, np.float64)[::cfg.sampling_ratio]
        if self.voxel_size <= 0:
            d2 = mean_knn_dist2_host(points)
            self.voxel_size = float(np.median(np.sqrt(d2)))
        pts = voxelize_points_host(points, self.voxel_size)
        n = len(pts)
        cap = capacity or cfg.capacity or int(
            max(n * cfg.capacity_multiplier, 1 << 12))
        cap = -(-cap // 128) * 128
        K, F = cfg.n_offsets, cfg.feat_dim
        dist2 = np.maximum(mean_knn_dist2_host(pts), 1e-7)
        scales = np.log(np.sqrt(dist2))[:, None].repeat(6, axis=1)

        def alloc(arr, shape, fill=0.0):
            out = np.full((cap,) + shape, fill, np.float32)
            out[:n] = arr
            return torch.as_tensor(out, device=device)

        anchors = {
            "anchor": alloc(pts, (3,)),
            "offset": torch.zeros((cap, K, 3), device=device),
            "feat": torch.zeros((cap, F), device=device),
            "scaling": alloc(scales, (6,), fill=-10.0),
            "rotation": alloc(np.tile([1.0, 0, 0, 0], (n, 1)), (4,),
                              fill=1.0),
            "opacity": torch.full((cap, 1), OPACITY_INIT, device=device),
        }
        return self._new_state(anchors, self.init_mlp(device, seed), n)

    # ---------------- decode ------------------------------------------
    def decode(self, anchors, mlp, campos, cam_uid: int, visible_mask,
               active, level_scale_gate=None) -> NeuralGaussians:
        """generate_neural_gaussians of the reference on the visible active
        anchors (their slots in ascending order; one host sync sizes the
        decode). level_scale_gate: an optional per-anchor [CA] multiplier
        on the decoded opacity (Octree-GS's progressive training)."""
        cfg = self.config
        K = cfg.n_offsets
        with span("sync.decode"):
            idx = torch.nonzero(visible_mask & active).squeeze(1)
        a = {k: x[idx] for k, x in anchors.items()}
        if level_scale_gate is not None:
            level_scale_gate = level_scale_gate[idx]

        ob = a["anchor"] - campos
        dist = torch.linalg.norm(ob, dim=-1, keepdim=True)
        view = ob / (dist + 1e-12)

        feat = a["feat"]
        if cfg.use_feat_bank:
            h = torch.cat([view, dist], dim=-1)
            h = torch.relu(h @ mlp["fb_w1"] + mlp["fb_b1"])
            bw = torch.softmax(h @ mlp["fb_w2"] + mlp["fb_b2"], dim=-1)
            F = feat.shape[-1]
            f1 = torch.repeat_interleave(feat[:, ::4], 4, dim=1)[:, :F]
            f2 = torch.repeat_interleave(feat[:, ::2], 2, dim=1)[:, :F]
            feat = f1 * bw[:, 0:1] + f2 * bw[:, 1:2] + feat * bw[:, 2:3]

        base = torch.cat([feat, view], dim=-1)
        base_d = torch.cat([feat, view, dist], dim=-1)

        h = base_d if cfg.add_opacity_dist else base
        h = torch.relu(h @ mlp["op_w1"] + mlp["op_b1"])
        neural_op = torch.tanh(h @ mlp["op_w2"] + mlp["op_b2"])   # [V, K]
        if level_scale_gate is not None:
            neural_op = neural_op * level_scale_gate[:, None]

        h = base_d if cfg.add_cov_dist else base
        h = torch.relu(h @ mlp["cov_w1"] + mlp["cov_b1"])
        scale_rot = (h @ mlp["cov_w2"] + mlp["cov_b2"]).reshape(-1, K, 7)

        hc = base_d if cfg.add_color_dist else base
        if cfg.appearance_dim > 0:
            app = mlp["appearance"][cam_uid]
            hc = torch.cat([hc, app.expand(hc.shape[0], app.shape[-1])],
                           dim=-1)
        h = torch.relu(hc @ mlp["col_w1"] + mlp["col_b1"])
        color = torch.sigmoid(h @ mlp["col_w2"] + mlp["col_b2"]).reshape(
            -1, K, 3)

        anchor_scaling = torch.exp(a["scaling"])                  # [V, 6]
        g_scaling = anchor_scaling[:, None, 3:6] * torch.sigmoid(
            scale_rot[..., :3])
        rot_raw = scale_rot[..., 3:7]
        g_rot = rot_raw / (torch.linalg.norm(rot_raw, dim=-1, keepdim=True)
                           + 1e-12)
        xyz = a["anchor"][:, None, :] + a["offset"] * anchor_scaling[
            :, None, :3]

        mask = neural_op > 0.0
        opac = torch.where(mask, neural_op, torch.zeros_like(neural_op))
        VK = neural_op.shape[0] * K
        return NeuralGaussians(
            xyz=xyz.reshape(VK, 3), color=color.reshape(VK, 3),
            opacity=opac.reshape(VK), scaling=g_scaling.reshape(VK, 3),
            rotation=g_rot.reshape(VK, 4), mask=mask.reshape(VK),
            neural_opacity=neural_op.reshape(VK), anchor_idx=idx)

    # ---------------- optimizer ---------------------------------------
    def learning_rates(self, step):
        """(anchor lrs, mlp lrs) as dicts. Rotation and opacity are frozen
        (lr 0), as are the feature bank without use_feat_bank and the
        appearance table without appearance_dim."""
        cfg = self.config
        s = self.spatial_lr_scale

        def e(init, final, max_steps):
            return expon_lr(step, init, final, lr_delay_mult=0.01,
                            max_steps=max_steps)

        anchor_lrs = {
            "anchor": e(cfg.position_lr_init * s, cfg.position_lr_final * s,
                        cfg.position_lr_max_steps)
            if cfg.position_lr_init > 0 else 0.0,
            "offset": e(cfg.offset_lr_init * s, cfg.offset_lr_final * s,
                        cfg.offset_lr_max_steps),
            "feat": cfg.feature_lr,
            "scaling": cfg.scaling_lr,
            "rotation": 0.0,
            "opacity": 0.0,
        }
        heads = {
            "op": e(cfg.mlp_opacity_lr_init, cfg.mlp_opacity_lr_final,
                    cfg.mlp_opacity_lr_max_steps),
            "cov": e(cfg.mlp_cov_lr_init, cfg.mlp_cov_lr_final,
                     cfg.mlp_cov_lr_max_steps),
            "col": e(cfg.mlp_color_lr_init, cfg.mlp_color_lr_final,
                     cfg.mlp_color_lr_max_steps),
            "fb": e(cfg.mlp_featurebank_lr_init,
                    cfg.mlp_featurebank_lr_final,
                    cfg.mlp_featurebank_lr_max_steps)
            if cfg.use_feat_bank else 0.0,
        }
        mlp_lrs = {k: heads[k.split("_")[0]] for k in MLP_NAMES
                   if k != "appearance"}
        mlp_lrs["appearance"] = (
            e(cfg.appearance_lr_init, cfg.appearance_lr_final,
              cfg.appearance_lr_max_steps)
            if cfg.appearance_dim > 0 else 0.0)
        return anchor_lrs, mlp_lrs

    # ---------------- statistics --------------------------------------
    ndc_grad_scale = staticmethod(VanillaGaussians.ndc_grad_scale)

    def expand_stats_inputs(self, ng: NeuralGaussians, radii, mean2d_grad,
                            cap: int):
        """The decode's [V*K] rows scattered back to anchor-slot order
        [CA*K] for update_stats (zero on the other anchors)."""
        K = self.config.n_offsets

        def back(a):
            a = a.reshape((-1, K) + a.shape[1:])
            out = torch.zeros((cap,) + a.shape[1:], dtype=a.dtype,
                              device=a.device)
            out[ng.anchor_idx] = a
            return out.reshape((cap * K,) + a.shape[2:])

        return (back(ng.neural_opacity), back(ng.mask), back(radii),
                back(mean2d_grad))

    @staticmethod
    def dp_merge_stats(old, local):
        """The statistics after a dp step: every field is a running sum,
        so each adds the ranks' deltas."""
        deltas = comm.all_reduce_many([local[k] - old[k] for k in STAT_NAMES])
        return {k: old[k] + d for k, d in zip(STAT_NAMES, deltas)}

    def update_stats(self, stats, neural_opacity, mask, radii, mean2d_grad,
                     visible_mask, active, grad_scale):
        """training_statis of the reference: the anchors' opacity sums and
        visit counts, the offsets' screen-gradient sums and counts."""
        K = self.config.n_offsets
        CA = stats["opacity_accum"].shape[0]
        vis = visible_mask & active
        op = torch.clamp(neural_opacity.reshape(CA, K), min=0.0)
        opacity_accum = torch.where(
            vis, stats["opacity_accum"] + torch.where(
                vis[:, None], op, torch.zeros_like(op)).sum(1),
            stats["opacity_accum"])
        anchor_denom = torch.where(vis, stats["anchor_denom"] + 1.0,
                                   stats["anchor_denom"])
        upd = (mask & (radii > 0)).reshape(CA, K)
        gnorm = torch.linalg.norm(mean2d_grad[:, :2] * grad_scale,
                                  dim=-1).reshape(CA, K)
        return {
            "opacity_accum": opacity_accum,
            "anchor_denom": anchor_denom,
            "offset_grad_accum": torch.where(
                upd, stats["offset_grad_accum"] + gnorm,
                stats["offset_grad_accum"]),
            "offset_denom": torch.where(upd, stats["offset_denom"] + 1.0,
                                        stats["offset_denom"]),
        }

    # ---------------- densification -----------------------------------
    def _grow_level(self, state: ScaffoldState, level: int, grads,
                    offset_mask, rand, voxel_size: float) -> ScaffoldState:
        """One level of anchor growing: the offsets whose mean screen
        gradient passes the level's threshold and whose uniform draw
        `rand` [CA, K] passes 0.5^(level+1) propose the voxel they fall
        in; voxels new to the anchors become anchors in free slots, with
        the largest feature of their candidates."""
        cfg = self.config
        an = state.anchors
        CA, K = an["offset"].shape[:2]
        dev = an["anchor"].device
        cur_thr = cfg.densify_grad_threshold * (
            (cfg.update_hierachy_factor // 2) ** level)
        size_factor = cfg.update_init_factor // (
            cfg.update_hierachy_factor ** level)
        cur_size = torch.tensor(voxel_size * size_factor,
                                dtype=torch.float32, device=dev)
        inv_size = reciprocal_f32(voxel_size * size_factor, dev)

        cand = ((grads >= cur_thr) & offset_mask
                & (rand > 0.5 ** (level + 1)) & state.active[:, None])
        anchor_scaling = torch.exp(an["scaling"][:, :3])
        all_xyz = an["anchor"][:, None, :] + an["offset"] * anchor_scaling[
            :, None]
        coords = torch.round(all_xyz.reshape(CA * K, 3) * inv_size).to(
            torch.int32)
        keys = hash_coords(coords)
        exist_keys = torch.where(
            state.active,
            hash_coords(torch.round(an["anchor"] * inv_size).to(
                torch.int32)),
            torch.full((CA,), KEY_MAX, dtype=torch.int32, device=dev))
        exist_sorted = torch.sort(exist_keys).values

        dd = dedup_against(keys, cand.reshape(CA * K), exist_sorted)
        coords_sorted = coords[dd.order]
        feat_sorted = torch.repeat_interleave(an["feat"], K, dim=0)[dd.order]
        feat_max = segment_max_sorted(feat_sorted, dd.seg_id, CA * K)
        state, _ = self._insert_anchors(
            state, dd.is_new, coords_sorted.float() * cur_size,
            feat_max[dd.seg_id], torch.log(cur_size))
        return state

    @staticmethod
    def _insert_anchors(state: ScaffoldState, is_new, anchor_rows, feat_rows,
                        log_size):
        """The candidates `is_new` become anchors in the free slots by rank,
        at anchor_rows with features feat_rows (rows in the candidates'
        order) and every scale log_size; their offsets, Adam moments and
        statistics start at zero. Candidates beyond the free slots are
        dropped. Returns (the new state, the mask of the slots filled)."""
        an = state.anchors
        CA = state.active.shape[0]
        dev = an["anchor"].device
        free = ~state.active
        free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
        free_list = torch.full((CA,), CA, dtype=torch.int64, device=dev)
        free_list[free_rank[free]] = torch.arange(CA, device=dev)[free]
        new_rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
        dst = torch.where(is_new,
                          free_list[torch.clamp(new_rank, max=CA - 1)], CA)
        dst = torch.where(new_rank < free.sum(), dst, CA)
        keep = dst < CA
        slots = dst[keep]

        newly = torch.zeros(CA, dtype=torch.bool, device=dev)
        newly[slots] = True
        anchor = an["anchor"].clone()
        anchor[slots] = anchor_rows[keep]
        feat = an["feat"].clone()
        feat[slots] = feat_rows[keep]
        anchors = {
            "anchor": anchor,
            "offset": _where_new(newly, an["offset"], 0.0),
            "feat": feat,
            "scaling": _where_new(newly, an["scaling"], log_size),
            "rotation": torch.where(
                newly[:, None], torch.tensor([1.0, 0, 0, 0], device=dev),
                an["rotation"]),
            "opacity": _where_new(newly, an["opacity"], OPACITY_INIT),
        }
        active = state.active | newly

        def zero_new(d):
            return {k: _where_new(newly, x, 0.0) for k, x in d.items()}

        return dataclasses.replace(
            state, anchors=anchors,
            adam_anchor=Adam(zero_new(state.adam_anchor.m),
                             zero_new(state.adam_anchor.v),
                             state.adam_anchor.count),
            stats=zero_new(state.stats), active=active,
            n_active=active.sum(dtype=torch.int32)), newly

    def offset_gradients(self, stats):
        """The offsets' mean screen gradients and the mask of the offsets
        seen often enough for them to count."""
        cfg = self.config
        grads = torch.nan_to_num(stats["offset_grad_accum"] / torch.clamp(
            stats["offset_denom"], min=1e-12))
        offset_mask = stats["offset_denom"] > (
            cfg.densification_interval * cfg.success_threshold * 0.5)
        return grads, offset_mask

    def adjust_anchor(self, state: ScaffoldState, voxel_size: float,
                      generator: Optional[torch.Generator] = None,
                      rands: Optional[List[torch.Tensor]] = None
                      ) -> ScaffoldState:
        """Anchor growing over update_depth levels, then the opacity-based
        prune (adjust_anchor of the reference). Level l's draw is
        rands[l] [CA, K] if given (the tests inject the reference's), else
        uniform from `generator`."""
        cfg = self.config
        st = state.stats
        CA, K = st["offset_denom"].shape
        grads, offset_mask = self.offset_gradients(st)
        for lvl in range(cfg.update_depth):
            rand = rands[lvl] if rands is not None else torch.rand(
                (CA, K), generator=generator, device=generator.device)
            state = self._grow_level(state, lvl, grads, offset_mask,
                                     rand.to(st["offset_denom"].device),
                                     voxel_size)
        return self._reset_and_prune(state, offset_mask)

    def _reset_and_prune(self, state: ScaffoldState,
                         offset_mask) -> ScaffoldState:
        """After growing: reset the sampled offsets' statistics, prune the
        anchors with a low accumulated opacity and clamp the log scaling's
        columns 3-5 at 0.05, as the reference does."""
        cfg = self.config
        st = state.stats
        zero = torch.zeros_like(st["offset_denom"])
        offset_denom = torch.where(offset_mask, zero, st["offset_denom"])
        offset_grad = torch.where(offset_mask, zero,
                                  st["offset_grad_accum"])
        seen = st["anchor_denom"] > (cfg.densification_interval
                                     * cfg.success_threshold)
        prune = ((st["opacity_accum"] < cfg.opacity_cull_threshold
                  * st["anchor_denom"]) & seen & state.active)
        zero_a = torch.zeros_like(st["opacity_accum"])
        opacity_accum = torch.where(seen, zero_a, st["opacity_accum"])
        anchor_denom = torch.where(seen, zero_a, st["anchor_denom"])
        active = state.active & ~prune
        sc = state.anchors["scaling"]
        sc = torch.cat([sc[:, :3], torch.clamp(sc[:, 3:], max=0.05)], dim=1)
        return dataclasses.replace(
            state, anchors={**state.anchors, "scaling": sc},
            stats={"opacity_accum": opacity_accum,
                   "anchor_denom": anchor_denom,
                   "offset_grad_accum": offset_grad,
                   "offset_denom": offset_denom},
            active=active, n_active=active.sum(dtype=torch.int32))

    # ---------------- serialization -----------------------------------
    def save_ply(self, state: ScaffoldState, path: str):
        """The scaffold PLY schema of the reference."""
        from gssr_tpu_torch.dataio.ply import write_ply
        write_ply(path, {k: v.astype(np.float32)
                         for k, v in self._ply_columns(state).items()})

    def _ply_columns(self, state: ScaffoldState) -> Dict[str, np.ndarray]:
        """The active anchors' PLY columns, in the reference's order."""
        act = state.active.cpu().numpy()
        an = {k: x.detach().cpu().numpy()[act]
              for k, x in state.anchors.items()}
        n = an["anchor"].shape[0]
        cols = {}
        for i, k in enumerate("xyz"):
            cols[k] = an["anchor"][:, i]
        for k in ("nx", "ny", "nz"):
            cols[k] = np.zeros(n, np.float32)
        off = an["offset"].transpose(0, 2, 1).reshape(n, -1)
        for i in range(off.shape[1]):
            cols[f"f_offset_{i}"] = off[:, i]
        for i in range(an["feat"].shape[1]):
            cols[f"f_anchor_feat_{i}"] = an["feat"][:, i]
        cols["opacity"] = an["opacity"][:, 0]
        for i in range(6):
            cols[f"scale_{i}"] = an["scaling"][:, i]
        for i in range(4):
            cols[f"rot_{i}"] = an["rotation"][:, i]
        return cols

    def save_mlp_checkpoints(self, state: ScaffoldState, path: str):
        """The MLP as an .npz of mlp_<field> arrays, and GS-SR's unite-mode
        checkpoints.pth beside it (models/interop.py)."""
        from gssr_tpu_torch.models.interop import save_gs_sr_mlp_checkpoint
        np.savez(path, **{f"mlp_{k}": state.mlp[k].detach().cpu().numpy()
                          for k in MLP_NAMES})
        save_gs_sr_mlp_checkpoint(os.path.dirname(os.path.abspath(path)),
                                  state.mlp,
                                  use_feat_bank=self.config.use_feat_bank)

    def load_mlp_checkpoints(self, state: ScaffoldState,
                             path: str) -> ScaffoldState:
        dev = state.active.device
        with np.load(path) as data:
            mlp = {k: torch.as_tensor(data[f"mlp_{k}"], device=dev)
                   for k in MLP_NAMES}
        return dataclasses.replace(state, mlp=mlp)

    def load_ply(self, path: str, device, capacity: Optional[int] = None,
                 seed: int = 0) -> ScaffoldState:
        from gssr_tpu_torch.dataio.ply import read_ply
        cfg = self.config
        cols = read_ply(path)
        n = len(cols["x"])
        K, F = cfg.n_offsets, cfg.feat_dim
        cap = capacity or cfg.capacity or -(-int(
            n * cfg.capacity_multiplier) // 128) * 128
        anchor = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        off = np.stack([cols[f"f_offset_{i}"] for i in range(3 * K)], axis=1)
        off = off.reshape(n, 3, K).transpose(0, 2, 1)
        feat = np.stack([cols[f"f_anchor_feat_{i}"] for i in range(F)],
                        axis=1)
        scaling = np.stack([cols[f"scale_{i}"] for i in range(6)], axis=1)
        rot = np.stack([cols[f"rot_{i}"] for i in range(4)], axis=1)

        def alloc(a, fill=0.0):
            out = np.full((cap,) + a.shape[1:], fill, np.float32)
            out[:n] = a
            return torch.as_tensor(out, device=device)

        # the base class's init (an octree subclass's needs cameras): it
        # sizes the MLP and, with voxel_size <= 0, sets the voxel size
        base = ScaffoldGaussians.create_from_points(
            self, anchor, device=device, capacity=cap, seed=seed)
        anchors = {"anchor": alloc(anchor), "offset": alloc(off),
                   "feat": alloc(feat), "scaling": alloc(scaling, -10.0),
                   "rotation": alloc(rot, 1.0),
                   "opacity": alloc(cols["opacity"][:, None], -10.0)}
        return self._new_state(anchors, base.mlp, n)
