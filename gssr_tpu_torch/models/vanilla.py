"""Vanilla 3DGS gaussian model (port of gssr_tpu/models/vanilla.py).

Same parameter groups, LR schedules, adaptive density control (clone /
split / prune / opacity reset) and PLY schema as the reference. The state
keeps the reference's fixed-capacity layout with an `active` mask, so
every comparison with gssr_tpu is slot for slot; densification writes new
points into free slots. State is plain dicts of tensors on one device;
operations return new state rather than updating in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gssr_tpu_torch.ops.knn import mean_knn_dist2_host
from gssr_tpu_torch.ops.sh import rgb_to_sh
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.utils.general import (
    expon_lr,
    inverse_sigmoid,
    quat_to_rotmat,
)
from gssr_tpu_torch.utils.tracing import span

PARAM_NAMES = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
STAT_NAMES = ("max_radii2d", "grad_accum", "denom")


@dataclasses.dataclass(frozen=True)
class VanillaGaussianConfig:
    max_sh_degree: int = 3
    percent_dense: float = 0.01
    sampling_ratio: int = 1

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001

    oneup_sh_interval: int = 1000
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    opacity_cull_threshold: float = 0.005

    capacity: int = 0                 # 0 => derived from init point count
    capacity_multiplier: float = 8.0


@dataclasses.dataclass
class GaussianState:
    """Parameters (xyz [C,3], f_dc [C,1,3], f_rest [C,K-1,3], scaling
    [C,3] log-scale, rotation [C,4], opacity [C,1] pre-sigmoid), their
    Adam moments and step count, densify statistics, the active mask."""
    params: Dict[str, torch.Tensor]
    adam_m: Dict[str, torch.Tensor]
    adam_v: Dict[str, torch.Tensor]
    adam_count: torch.Tensor           # [] int32
    stats: Dict[str, torch.Tensor]     # STAT_NAMES, each [C] float32
    active: torch.Tensor               # [C] bool
    n_active: torch.Tensor             # [] int32


def _zeros_like(d):
    return {k: torch.zeros_like(v) for k, v in d.items()}


@dataclasses.dataclass
class Adam:
    """Adam's moments over a dict of parameters and its step count."""
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: torch.Tensor                # [] int32

    @classmethod
    def zeros(cls, params) -> "Adam":
        dev = next(iter(params.values())).device
        return cls(_zeros_like(params), _zeros_like(params),
                   torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(params, grads, adam: Adam, lrs, b1=0.9, b2=0.999,
                eps=1e-15):
    """Per-group Adam over dicts of tensors (eps 1e-15 as in the reference
    trainer). A group with lr 0 keeps its value while its moments advance.
    Returns (new params, new Adam)."""
    count = adam.count + 1
    t = count.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new_p, ms, vs = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = b1 * adam.m[k] + (1 - b1) * g
        v = b2 * adam.v[k] + (1 - b2) * g * g
        new_p[k] = p - lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        ms[k], vs[k] = m, v
    return new_p, Adam(ms, vs, count)


class VanillaGaussians:
    """Config + static scene info; state-changing operations are pure."""

    scale_dim = 3

    def __init__(self, config: VanillaGaussianConfig,
                 spatial_lr_scale: float = 1.0):
        self.config = config
        self.spatial_lr_scale = float(spatial_lr_scale)

    # ---------------- activations -------------------------------------
    @staticmethod
    def get_scaling(params):
        return torch.exp(params["scaling"])

    @staticmethod
    def get_opacity(params):
        return torch.sigmoid(params["opacity"])

    @staticmethod
    def get_rotation(params):
        r = params["rotation"]
        return r / (torch.linalg.norm(r, dim=-1, keepdim=True) + 1e-12)

    # ---------------- init --------------------------------------------
    def _new_state(self, params, n: int) -> GaussianState:
        cap = params["xyz"].shape[0]
        dev = params["xyz"].device
        return GaussianState(
            params=params, adam_m=_zeros_like(params),
            adam_v=_zeros_like(params),
            adam_count=torch.zeros((), dtype=torch.int32, device=dev),
            stats={k: torch.zeros(cap, device=dev) for k in STAT_NAMES},
            active=torch.arange(cap, device=dev) < n,
            n_active=torch.tensor(n, dtype=torch.int32, device=dev))

    def create_from_points(self, points: np.ndarray, colors: np.ndarray,
                           device, capacity: Optional[int] = None
                           ) -> GaussianState:
        cfg = self.config
        points = np.asarray(points, np.float32)[::cfg.sampling_ratio]
        colors = np.asarray(colors, np.float32)[::cfg.sampling_ratio]
        n = len(points)
        cap = capacity or cfg.capacity or int(
            max(n * cfg.capacity_multiplier, 1 << 14))
        cap = -(-cap // 128) * 128
        K = (cfg.max_sh_degree + 1) ** 2
        dist2 = np.maximum(mean_knn_dist2_host(points), 1e-7)
        scales = np.log(np.sqrt(dist2))[:, None].repeat(self.scale_dim, 1)
        op0 = float(inverse_sigmoid(torch.tensor(0.1)))

        def alloc(arr, shape, fill=0.0):
            out = np.full((cap,) + shape, fill, np.float32)
            out[:n] = arr
            return torch.as_tensor(out, device=device)

        params = {
            "xyz": alloc(points, (3,)),
            "f_dc": alloc(rgb_to_sh(colors)[:, None, :], (1, 3)),
            "f_rest": torch.zeros((cap, K - 1, 3), device=device),
            "scaling": alloc(scales, (self.scale_dim,), fill=-10.0),
            "rotation": alloc(np.tile([1.0, 0, 0, 0], (n, 1)), (4,),
                              fill=1.0),
            "opacity": alloc(np.full((n, 1), op0), (1,), fill=-10.0),
        }
        return self._new_state(params, n)

    # ---------------- optimizer ---------------------------------------
    def learning_rates(self, step) -> Dict[str, float]:
        cfg = self.config
        return {
            "xyz": expon_lr(step, cfg.position_lr_init * self.spatial_lr_scale,
                            cfg.position_lr_final * self.spatial_lr_scale,
                            lr_delay_mult=cfg.position_lr_delay_mult,
                            max_steps=cfg.position_lr_max_steps),
            "f_dc": cfg.feature_lr,
            "f_rest": cfg.feature_lr / 20.0,
            "scaling": cfg.scaling_lr,
            "rotation": cfg.rotation_lr,
            "opacity": cfg.opacity_lr,
        }

    @staticmethod
    def adam_step(state: GaussianState, grads, lrs) -> GaussianState:
        """Per-group Adam on the state's parameters (adam_update)."""
        params, adam = adam_update(
            state.params, grads,
            Adam(state.adam_m, state.adam_v, state.adam_count), lrs)
        return dataclasses.replace(state, params=params, adam_m=adam.m,
                                   adam_v=adam.v, adam_count=adam.count)

    # ---------------- densification -----------------------------------
    @staticmethod
    def ndc_grad_scale(width, height, device=None):
        """Pixel-grad -> reference NDC-grad factor: the reference CUDA
        backward returns dL/dmean2D scaled by 0.5*W, 0.5*H, and
        densify_grad_threshold is calibrated to that scale."""
        with span("sync.grad_scale"):
            return torch.tensor([0.5 * width, 0.5 * height],
                                dtype=torch.float32, device=device)

    @staticmethod
    def update_stats(stats, radii, mean2d_grad, grad_scale):
        visible = radii > 0
        gnorm = torch.linalg.norm(mean2d_grad[:, :2] * grad_scale, dim=-1)
        return {
            "max_radii2d": torch.where(
                visible, torch.maximum(stats["max_radii2d"], radii.float()),
                stats["max_radii2d"]),
            "grad_accum": torch.where(visible, stats["grad_accum"] + gnorm,
                                      stats["grad_accum"]),
            "denom": torch.where(visible, stats["denom"] + 1.0,
                                 stats["denom"]),
        }

    @staticmethod
    def dp_merge_stats(old, local):
        """The statistics after a dp step: each rank accumulated its own
        camera's delta on top of `old`; the sums add the deltas over the
        ranks, the radius maximum reduces directly."""
        d_grad, d_denom = comm.all_reduce_many(
            [local["grad_accum"] - old["grad_accum"],
             local["denom"] - old["denom"]])
        return {"max_radii2d": comm.all_reduce(local["max_radii2d"], "max"),
                "grad_accum": old["grad_accum"] + d_grad,
                "denom": old["denom"] + d_denom}

    def densify_and_prune(self, state: GaussianState, use_size_prune: bool,
                          generator: Optional[torch.Generator] = None,
                          noise=None) -> GaussianState:
        """Clone + split + prune with the reference's thresholds. Clones
        and split children land in free slots by rank; their Adam moments
        and all statistics start at zero. The split samples are `noise`
        [2, C, 3] if given, else standard normals from `generator`."""
        cfg = self.config
        extent = self.spatial_lr_scale
        p = state.params
        cap = p["xyz"].shape[0]
        dev = p["xyz"].device
        active = state.active

        grads = torch.nan_to_num(state.stats["grad_accum"] / torch.clamp(
            state.stats["denom"], min=1.0))
        scaling = self.get_scaling(p)
        max_scale = scaling.max(dim=-1).values
        opacity = self.get_opacity(p)[:, 0]

        hot = active & (grads >= cfg.densify_grad_threshold)
        small = max_scale <= cfg.percent_dense * extent
        clone_mask = hot & small
        split_mask = hot & ~small

        prune = active & (opacity < cfg.opacity_cull_threshold)
        if use_size_prune:
            big_ws = max_scale > 0.1 * extent
            big_vs = state.stats["max_radii2d"] > 20.0
            prune = prune | (active & (big_ws | big_vs))
        if noise is None:
            noise = torch.randn((2, cap, self.scale_dim), generator=generator,
                                device=dev)
        return self.place_densified(state, clone_mask, split_mask, prune,
                                    noise)

    def place_densified(self, state: GaussianState, clone_mask, split_mask,
                        prune, child_noise, clone_noise=None
                        ) -> GaussianState:
        """Apply a densify decision: drop the pruned and split gaussians,
        write clones and the two children of each split into free slots by
        rank (child c displaced by child_noise[c], a clone by clone_noise
        or not at all), zero the new slots' Adam moments and every
        statistic."""
        p = state.params
        cap = p["xyz"].shape[0]
        dev = p["xyz"].device
        new_active = state.active & ~prune & ~split_mask

        # free-slot allocation: rank -> slot table of the free slots
        slots = torch.arange(cap, dtype=torch.int32, device=dev)
        free = ~new_active
        free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
        free_list = torch.full((cap,), cap, dtype=torch.int32, device=dev)
        free_list[free_rank[free].long()] = slots[free]

        n_clone = clone_mask.sum(dtype=torch.int32)
        n_split = split_mask.sum(dtype=torch.int32)
        clone_rank = torch.cumsum(clone_mask.to(torch.int32), 0) - 1
        split_rank = torch.cumsum(split_mask.to(torch.int32), 0) - 1

        def dest(mask, rank, offset):
            r = torch.where(mask, rank + offset, cap)
            return torch.where(
                r < cap, free_list[torch.clamp(r, max=cap - 1).long()], cap)

        dest_clone = dest(clone_mask, clone_rank, 0)
        dest_child1 = dest(split_mask, split_rank, n_clone)
        dest_child2 = dest(split_mask, split_rank, n_clone + n_split)

        R = quat_to_rotmat(p["rotation"])
        scaling = self.get_scaling(p)
        child_scaling = torch.log(scaling / (0.8 * 2.0))

        def place(acc, dst, overrides):
            keep = dst < cap
            out = {}
            for k, d in acc.items():
                d = d.clone()
                d[dst[keep].long()] = overrides.get(k, p[k])[keep]
                out[k] = d
            return out

        new_params = place(p, dest_clone, {} if clone_noise is None else {
            "xyz": p["xyz"] + self.split_displacement(R, scaling,
                                                      clone_noise)})
        for c, dst in ((0, dest_child1), (1, dest_child2)):
            samples = self.split_displacement(R, scaling, child_noise[c])
            new_params = place(new_params, dst,
                               {"xyz": p["xyz"] + samples,
                                "scaling": child_scaling})

        placed = torch.zeros(cap, dtype=torch.bool, device=dev)
        for dst in (dest_clone, dest_child1, dest_child2):
            placed[dst[dst < cap].long()] = True
        final_active = new_active | placed

        def reset_new(x):
            k = new_active.reshape((-1,) + (1,) * (x.ndim - 1))
            return torch.where(k, x, torch.zeros_like(x))

        # dead slots render as nothing
        new_params["opacity"] = torch.where(
            final_active[:, None], new_params["opacity"],
            torch.full_like(new_params["opacity"], -10.0))
        return GaussianState(
            params=new_params,
            adam_m={k: reset_new(v) for k, v in state.adam_m.items()},
            adam_v={k: reset_new(v) for k, v in state.adam_v.items()},
            adam_count=state.adam_count,
            stats=_zeros_like(state.stats),
            active=final_active,
            n_active=final_active.sum(dtype=torch.int32))

    def split_displacement(self, R, scaling, noise):
        """World-space sample offset of a split child."""
        return torch.einsum("nij,nj->ni", R, noise * scaling)

    def reset_opacity(self, state: GaussianState) -> GaussianState:
        """Clamp opacity to <= 0.01 and reset its Adam moments."""
        new_op = inverse_sigmoid(torch.clamp(self.get_opacity(state.params),
                                             max=0.01))
        return dataclasses.replace(
            state, params={**state.params, "opacity": new_op},
            adam_m={**state.adam_m, "opacity": torch.zeros_like(new_op)},
            adam_v={**state.adam_v, "opacity": torch.zeros_like(new_op)})

    def active_sh_degree(self, step: int) -> int:
        return min(step // self.config.oneup_sh_interval,
                   self.config.max_sh_degree)

    # ---------------- serialization -----------------------------------
    def save_ply(self, state: GaussianState, path: str):
        """3DGS-ecosystem PLY schema."""
        from gssr_tpu_torch.dataio.ply import write_ply
        active = state.active.cpu().numpy()
        p = {k: v.detach().cpu().numpy()[active]
             for k, v in state.params.items()}
        n = p["xyz"].shape[0]
        cols = {}
        for i, k in enumerate("xyz"):
            cols[k] = p["xyz"][:, i]
        for k in ("nx", "ny", "nz"):
            cols[k] = np.zeros(n, np.float32)
        f_dc = p["f_dc"].transpose(0, 2, 1).reshape(n, -1)   # channel-major
        for i in range(f_dc.shape[1]):
            cols[f"f_dc_{i}"] = f_dc[:, i]
        f_rest = p["f_rest"].transpose(0, 2, 1).reshape(n, -1)
        for i in range(f_rest.shape[1]):
            cols[f"f_rest_{i}"] = f_rest[:, i]
        cols["opacity"] = p["opacity"][:, 0]
        for i in range(self.scale_dim):
            cols[f"scale_{i}"] = p["scaling"][:, i]
        for i in range(4):
            cols[f"rot_{i}"] = p["rotation"][:, i]
        write_ply(path, {k: v.astype(np.float32) for k, v in cols.items()})

    def load_ply(self, path: str, device,
                 capacity: Optional[int] = None) -> GaussianState:
        from gssr_tpu_torch.dataio.ply import read_ply
        cols = read_ply(path)
        n = len(cols["x"])
        K = (self.config.max_sh_degree + 1) ** 2
        cap = capacity or self.config.capacity or -(-int(
            n * self.config.capacity_multiplier) // 128) * 128
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1)
        f_rest = np.stack([cols[f"f_rest_{i}"] for i in range(3 * (K - 1))],
                          axis=1).reshape(n, 3, K - 1).transpose(0, 2, 1)
        scaling = np.stack([cols[f"scale_{i}"]
                            for i in range(self.scale_dim)], axis=1)
        rotation = np.stack([cols[f"rot_{i}"] for i in range(4)], axis=1)

        def alloc(a, fill=0.0):
            out = np.full((cap,) + a.shape[1:], fill, np.float32)
            out[:n] = a
            return torch.as_tensor(out, device=device)

        params = {
            "xyz": alloc(xyz), "f_dc": alloc(f_dc[:, None, :]),
            "f_rest": alloc(f_rest), "scaling": alloc(scaling, fill=-10.0),
            "rotation": alloc(rotation, fill=1.0),
            "opacity": alloc(cols["opacity"][:, None], fill=-10.0)}
        return self._new_state(params, n)
