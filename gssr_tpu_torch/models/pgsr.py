"""PGSR gaussian model (port of gssr_tpu/models/pgsr.py): a second gradient
accumulator fed by the rasterizer's abs screen-space gradients, an
abs-split gated by screen radius, a global point budget (max_all_points)
enforced by quantile re-thresholding, a clone that samples a new position,
and radius statistics gated by the observe count.

The extra statistics ride beside the state as a dict of [C] tensors, as
the reference's extra-stats pytree does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from gssr_tpu_torch.models.vanilla import (
    GaussianState,
    VanillaGaussianConfig,
    VanillaGaussians,
)
from gssr_tpu_torch.parallel import comm

# the reference's extra-stats keys, in the order jax.tree flattens them
EXTRA_NAMES = ("denom_abs", "grad_accum_abs", "max_weight")


@dataclasses.dataclass(frozen=True)
class PGSRGaussianConfig(VanillaGaussianConfig):
    densify_abs_grad_threshold: float = 0.0008
    abs_split_radii2D_threshold: float = 20.0
    max_abs_split_points: int = 50_000
    max_all_points: int = 6_000_000
    percent_dense: float = 0.001


def quantile_linear(x, q):
    """jnp.quantile(x, q) with linear interpolation, for a flat float32 x
    of any size (torch.quantile refuses more than 2^24 elements): the
    sorted values at floor and ceil of q * (n - 1), weighted by its
    fractional part, every step in float32 as the reference takes it."""
    v = torch.sort(x).values
    n = x.numel()
    pos = torch.as_tensor(q, dtype=torch.float32, device=x.device) * (n - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low_v = v[torch.clamp(low, 0, n - 1).long()]
    high_v = v[torch.clamp(high, 0, n - 1).long()]
    return low_v * low_w + high_v * high_w


class PGSRGaussians(VanillaGaussians):
    config: PGSRGaussianConfig

    @staticmethod
    def init_extra_stats(cap: int, device) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros(cap, device=device) for k in EXTRA_NAMES}

    @staticmethod
    def update_stats_pgsr(stats, extra, radii, mean2d_grad, mean2d_abs_grad,
                          observe, grad_scale):
        """The densification statistics of a step, the abs channel beside
        them, and the radius max gated by observe > 0. grad_scale: the
        [2] pixel-to-NDC factor (VanillaGaussians.ndc_grad_scale)."""
        visible = radii > 0
        obs_mask = visible & (observe > 0)
        gnorm = torch.linalg.norm(mean2d_grad[:, :2] * grad_scale, dim=-1)
        gnorm_abs = torch.linalg.norm(mean2d_abs_grad[:, :2] * grad_scale,
                                      dim=-1)
        new_stats = {
            "max_radii2d": torch.where(
                obs_mask, torch.maximum(stats["max_radii2d"], radii.float()),
                stats["max_radii2d"]),
            "grad_accum": torch.where(visible, stats["grad_accum"] + gnorm,
                                      stats["grad_accum"]),
            "denom": torch.where(visible, stats["denom"] + 1.0,
                                 stats["denom"]),
        }
        new_extra = {
            "grad_accum_abs": torch.where(
                visible, extra["grad_accum_abs"] + gnorm_abs,
                extra["grad_accum_abs"]),
            "denom_abs": torch.where(visible, extra["denom_abs"] + 1.0,
                                     extra["denom_abs"]),
            "max_weight": extra["max_weight"],
        }
        return new_stats, new_extra

    @staticmethod
    def dp_merge_extra(old, local):
        """The abs-gradient statistics after a dp step: the sums add the
        ranks' deltas, max_weight reduces directly."""
        d_grad, d_denom = comm.all_reduce_many(
            [local["grad_accum_abs"] - old["grad_accum_abs"],
             local["denom_abs"] - old["denom_abs"]])
        return {"grad_accum_abs": old["grad_accum_abs"] + d_grad,
                "denom_abs": old["denom_abs"] + d_denom,
                "max_weight": comm.all_reduce(local["max_weight"], "max")}

    @staticmethod
    def _budget_reselect(sel, grads, n_active, budget):
        """When a selection would take the active count past `budget`, keep
        only its gradients above the quantile that leaves room for it."""
        want = sel.sum(dtype=torch.int32)
        over = n_active + want > budget
        limited = torch.clamp(budget - n_active, min=0)
        ratio = torch.clamp(limited.float()
                            / torch.clamp(n_active.float(), min=1.0),
                            0.0, 1.0)
        gtmp = torch.where(sel, grads, 0.0)
        sel2 = gtmp > quantile_linear(gtmp, 1.0 - ratio)
        return torch.where(over, sel2, sel)

    def densify_and_prune(self, state: GaussianState, use_size_prune: bool,
                          extra: Dict[str, torch.Tensor],
                          generator: Optional[torch.Generator] = None,
                          noise=None):
        """Clone (at a sampled position) and split with the abs-gradient
        channel under the point budget, then prune. The position samples
        are `noise` [3, C, 3] (clone, child 1, child 2) if given, else
        standard normals from `generator`. Returns (state, extra stats),
        both statistics reset."""
        cfg = self.config
        extent = self.spatial_lr_scale
        p = state.params
        cap = p["xyz"].shape[0]
        active = state.active
        n0 = state.n_active

        grads = torch.nan_to_num(state.stats["grad_accum"] / torch.clamp(
            state.stats["denom"], min=1e-12))
        grads_abs = torch.nan_to_num(extra["grad_accum_abs"] / torch.clamp(
            extra["denom_abs"], min=1e-12))
        max_scale = self.get_scaling(p).max(dim=-1).values
        opacity = self.get_opacity(p)[:, 0]
        small = max_scale <= cfg.percent_dense * extent
        hot = active & (grads >= cfg.densify_grad_threshold)

        clone_mask = self._budget_reselect(hot & small, grads, n0,
                                           cfg.max_all_points) & active

        split_base = hot & ~small
        want_split = split_base.sum(dtype=torch.int32)
        over = n0 + want_split > cfg.max_all_points
        split_budget = self._budget_reselect(split_base, grads, n0,
                                             cfg.max_all_points) & active
        abs_gate = (active & ~small & ~split_base
                    & (state.stats["max_radii2d"]
                       > cfg.abs_split_radii2D_threshold))
        abs_sel = abs_gate & (grads_abs >= cfg.densify_abs_grad_threshold)
        limited_abs = torch.clamp(
            torch.clamp(cfg.max_all_points - n0 - want_split, min=0),
            max=cfg.max_abs_split_points)
        abs_sel = self._budget_reselect(abs_sel, grads_abs, n0,
                                        n0 + limited_abs) & abs_gate
        split_mask = torch.where(over, split_budget, split_base | abs_sel)

        prune = active & (opacity < cfg.opacity_cull_threshold)
        if use_size_prune:
            big_ws = max_scale > 0.1 * extent
            big_vs = state.stats["max_radii2d"] > 20.0
            prune = prune | (active & (big_ws | big_vs))
        if noise is None:
            noise = torch.randn((3, cap, self.scale_dim), generator=generator,
                                device=p["xyz"].device)
        new_state = self.place_densified(state, clone_mask, split_mask, prune,
                                         noise[1:], clone_noise=noise[0])
        return new_state, {k: torch.zeros_like(v) for k, v in extra.items()}
