"""Scaffold-GS scene: anchor prefilter, neural-gaussian decode and render
(port of gssr_tpu/scene/scaffold.py).

A train step finds the anchors whose 3-sigma footprint reaches the image
(the vanilla preprocess without opacity), decodes their neural gaussians
with the MLP and renders them through the vanilla blend kernels
(ops/rasterize.py with precomputed colours). Autograd runs through render
and decode into the anchors and the MLP; Adam updates both, and the
statistics behind anchor growing accumulate inside the start_stat /
densify_until_iter window. The step's stages run inside profiler ranges
(scaffold.prefilter, .decode, .render_and_loss, .backward, .adam,
.stats), for `chip_smoke.py --profile`'s table; while no profiler
records, a range costs one host call. The hook names (prefilter_anchors,
decode_and_render, _rasterize_neural, extra_losses, scaling_loss,
anchor_level_gate) are the reference's, for the octree and anchor-surfel
scenes to override; step_terms lets the planar anchor scenes add a
neighbour's render to a step.

The multi-device modes are scene/vanilla.py's. Under gshard the anchor
state is sharded and the MLP replicated: its gradient, which saw only
this rank's anchors, is summed over the ranks, and the scaling loss's
masked mean takes the global sum and count. The ranks decode different
numbers of visible anchors, so the gather of their neural gaussians is
padded to the largest count (render_neural).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import field
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from gssr_tpu_torch.models.convert import (
    scaffold_state_from_numpy,
    scaffold_state_to_numpy,
)
from gssr_tpu_torch.models.scaffold import (
    ANCHOR_NAMES,
    MLP_NAMES,
    ScaffoldGaussianConfig,
    ScaffoldGaussians,
    ScaffoldState,
)
from gssr_tpu_torch.models.vanilla import adam_update
from gssr_tpu_torch.ops.projection import preprocess
from gssr_tpu_torch.ops.rasterize import pad_to_tiles, rasterize
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.scene.vanilla import VanillaScene, VanillaSceneConfig

# a filler neural gaussian of a padded gshard gather: a dead vanilla
# slot's geometry (scaling exp(-10), the identity rotation), masked off
_FILLER = {"scaling": float(np.exp(-10.0)), "rotation": (1.0, 0.0, 0.0, 0.0)}


@dataclasses.dataclass
class ScaffoldSceneConfig(VanillaSceneConfig):
    gaussians: ScaffoldGaussianConfig = field(
        default_factory=ScaffoldGaussianConfig)
    lambda_scaling: float = 0.01


class ScaffoldScene(VanillaScene):
    config: ScaffoldSceneConfig
    # gshard splits the anchors, their Adam moments and statistics; the
    # MLP, its Adam state and Adam's counts are replicated
    SHARDED = ("anchors", "adam_anchor.m", "adam_anchor.v", "stats",
               "active")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # (step, anchors grown, anchors pruned, active after) per
        # adjust_anchor
        self.anchor_log: List[tuple] = []

    def make_gaussians(self) -> ScaffoldGaussians:
        return ScaffoldGaussians(
            self.config.gaussians, spatial_lr_scale=self.cameras_extent,
            num_cameras=len(self.dataloader.train_cameras))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefilter_anchors(self, anchors, active, camera):
        """The anchors whose 3-sigma footprint (their first three scales)
        reaches the padded image: radius > 0 of the vanilla preprocess
        without opacity."""
        pw, ph = pad_to_tiles(self.width, self.height)
        g = self.gaussians
        proj = preprocess(anchors["anchor"],
                          torch.exp(anchors["scaling"][:, :3]),
                          g.get_rotation(anchors), camera, pw, ph,
                          scaling_modifier=self.config.scaling_modifier,
                          active_mask=active)
        return proj.radius > 0

    def decode_and_render(self, anchors, mlp, camera, cam_uid: int, visible,
                          active, bg, level_scale_gate=None, **par):
        ng = self.gaussians.decode(anchors, mlp, camera.campos, cam_uid,
                                   visible, active,
                                   level_scale_gate=level_scale_gate)
        return ng, self.render_neural(ng, camera, bg, **par)

    def render_neural(self, ng, camera, bg, mean2d_offset=None, **par):
        """_rasterize_neural with the rasterizer's multi-device arguments
        `par` (render_par). Under gshard each rank pads its neural
        gaussians to the largest count over the ranks (one all_reduce MAX)
        with masked-off fillers, so that the gathers line up; the returned
        radii and mean2d are this rank's own rows."""
        if not par.get("gauss_shard"):
            return self._rasterize_neural(ng, camera, bg, mean2d_offset,
                                          **par)
        n = ng.xyz.shape[0]
        n_max = int(comm.all_reduce(torch.tensor(n, device=ng.xyz.device),
                                    "max"))

        def pad(x, fill=0.0):
            tail = x.new_empty((n_max - n,) + tuple(x.shape[1:]))
            tail[:] = torch.as_tensor(fill, dtype=x.dtype)
            return torch.cat([x, tail])

        padded = ng._replace(
            xyz=pad(ng.xyz), color=pad(ng.color), opacity=pad(ng.opacity),
            scaling=pad(ng.scaling, _FILLER["scaling"]),
            rotation=pad(ng.rotation, _FILLER["rotation"]),
            mask=pad(ng.mask, False))
        if mean2d_offset is not None:
            mean2d_offset = pad(mean2d_offset)
        out = self._rasterize_neural(padded, camera, bg, mean2d_offset,
                                     **par)
        return out._replace(radii=out.radii[:n], mean2d=out.mean2d[:n])

    def _rasterize_neural(self, ng, camera, bg, mean2d_offset=None, **par):
        return rasterize(
            ng.xyz, ng.scaling, ng.rotation, ng.opacity, camera, self.width,
            self.height, bg, colors_precomp=ng.color, active_mask=ng.mask,
            scaling_modifier=self.config.scaling_modifier,
            mean2d_offset=mean2d_offset, **par)

    def extra_losses(self, ng, out, step: int, camera) -> Dict[str, object]:
        return {"scaling_loss": self.scaling_loss(ng)}

    def step_terms(self, state, anchors, mlp, ng, out, gt, bg, step: int,
                   camera, cam, cams) -> Dict[str, object]:
        """The losses of a train step: the image losses and extra_losses of
        the render `out` (over background bg) of the neural gaussians `ng`
        decoded from anchors and mlp for `camera` (a host Camera; cam its
        CameraArrays; cams every camera of the step, step_cameras). The
        planar anchor scenes add a neighbour's render."""
        terms = self.loss_terms(out, gt, step, cam)
        terms.update(self.extra_losses(ng, out, step, cam))
        return terms

    def scaling_loss(self, ng, dims: int = 3):
        """lambda_scaling times the mean, over the decoded gaussians that
        render, of the product of their first `dims` scales.

        Under gshard `ng` is this rank's anchor shard: the mean takes the
        sum and count over the ranks, the collective outside autograd with
        the local summand re-added, so that each rank differentiates
        exactly its own shard's part (and the loss stays replicated, as
        the rasterizer's gather contract needs)."""
        s = torch.where(ng.mask, torch.prod(ng.scaling[:, :dims], dim=-1),
                        torch.zeros_like(ng.opacity)).sum()
        cnt = ng.mask.sum().float()
        if self.parallel.mode == "gshard":
            s = s + (comm.all_reduce(s) - s.detach())
            cnt = comm.all_reduce(cnt)
        return self.config.lambda_scaling * s / torch.clamp(cnt, min=1.0)

    def anchor_level_gate(self, state, camera, step, is_training=True):
        """Octree hook: per anchor (extra visibility mask, opacity gate)."""
        return None, None

    def visible_anchors(self, state: ScaffoldState, camera, step,
                        is_training=True):
        """The prefilter's anchors narrowed by the level gate's mask, the
        gate, and the count of active anchors that mask drops (0-d; zero
        without a mask)."""
        extra_mask, gate = self.anchor_level_gate(state, camera, step,
                                                  is_training)
        visible = self.prefilter_anchors(state.anchors, state.active, camera)
        dropped = torch.zeros((), dtype=torch.int64, device=visible.device)
        if extra_mask is not None:
            visible = visible & extra_mask
            dropped = (state.active & ~extra_mask).sum()
        return visible, gate, dropped

    # ------------------------------------------------------------------
    def train_step(self, state: ScaffoldState, camera, step: int):
        """One step: prefilter, decode, render, L1 + D-SSIM + scaling loss,
        backward into anchors and MLP, Adam on both, statistics inside
        the window, on `camera` (in dp the list of every rank's,
        step_cameras). Returns (new state, metrics as 0-d tensors)."""
        cams, camera = self.step_cameras(camera)
        g = self.gaussians
        cfg = self.config.gaussians
        cam = camera.arrays(self.device)
        gt = self.gt_device(camera)
        bg = self.get_background()
        with record_function("scaffold.prefilter"):
            visible, gate, lod_dropped = self.visible_anchors(state, cam,
                                                              step)
        anchors = {k: v.detach().requires_grad_(True)
                   for k, v in state.anchors.items()}
        mlp = {k: v.detach().requires_grad_(True)
               for k, v in state.mlp.items()}
        with record_function("scaffold.decode"):
            ng = g.decode(anchors, mlp, cam.campos, camera.uid, visible,
                          state.active, level_scale_gate=gate)
        m2d_offset = torch.zeros_like(ng.xyz[:, :2], requires_grad=True)
        with record_function("scaffold.render_and_loss"):
            out = self.render_neural(ng, cam, bg, mean2d_offset=m2d_offset,
                                     **self.render_par())
            terms = self.step_terms(state, anchors, mlp, ng, out, gt, bg,
                                    step, camera, cam, cams)
            loss = sum(terms.values())
        inputs = ([anchors[k] for k in ANCHOR_NAMES]
                  + [mlp[k] for k in MLP_NAMES] + [m2d_offset])
        with record_function("scaffold.backward"):
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(inputs, grads)]
        na = len(ANCHOR_NAMES)
        grads = (self.merge_grads(grads[:na])
                 + self.merge_grads(grads[na:-1], shared=True)
                 + self.merge_screen_grads(grads[-1:]))
        with torch.no_grad(), record_function("scaffold.adam"):
            a_lrs, m_lrs = g.learning_rates(step)
            new_anchors, adam_a = adam_update(
                state.anchors, dict(zip(ANCHOR_NAMES, grads[:na])),
                state.adam_anchor, a_lrs)
            new_mlp, adam_m = adam_update(
                state.mlp, dict(zip(MLP_NAMES, grads[na:-1])),
                state.adam_mlp, m_lrs)
        with torch.no_grad(), record_function("scaffold.stats"):
            stats = state.stats
            if cfg.start_stat < step < cfg.densify_until_iter:
                cap = state.active.shape[0]
                stats = g.update_stats(
                    stats, *g.expand_stats_inputs(ng, out.radii, grads[-1],
                                                  cap),
                    visible, state.active,
                    g.ndc_grad_scale(self.width, self.height, self.device))
                if self.parallel.mode == "dp":
                    stats = g.dp_merge_stats(state.stats, stats)
        new_state = dataclasses.replace(
            state, anchors=new_anchors, mlp=new_mlp, adam_anchor=adam_a,
            adam_mlp=adam_m, stats=stats)
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics.update(loss=loss.detach(), num_rendered=out.num_rendered,
                       overflow=out.overflow,
                       n_visible=torch.tensor(ng.anchor_idx.shape[0]),
                       n_neural=ng.mask.sum(), n_lod_dropped=lod_dropped)
        return new_state, self.merge_metrics(metrics)

    # ------------------------------------------------------------------
    def densify_due(self, step: int) -> bool:
        cfg = self.config.gaussians
        return (cfg.densify_from_iter < step < cfg.densify_until_iter
                and step % cfg.densification_interval == 0)

    def densify(self, state: ScaffoldState, step: int,
                rands=None) -> ScaffoldState:
        """adjust_anchor on the reference's schedule. `rands` replaces its
        uniform draws, one [CA, K] per level (tests inject the
        reference's)."""
        if self.densify_due(step):
            before = state.active
            with torch.no_grad():
                state = self.gaussians.adjust_anchor(
                    state, self.gaussians.voxel_size,
                    generator=self.generator, rands=rands)
            self.anchor_log.append((
                step, int((state.active & ~before).sum()),
                int((before & ~state.active).sum()), int(state.n_active)))
        return state

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_render(self, state: ScaffoldState, camera, step: int):
        cam = camera.arrays(self.device)
        visible, gate, _ = self.visible_anchors(state, cam, 0,
                                                is_training=False)
        _, out = self.decode_and_render(state.anchors, state.mlp, cam,
                                        camera.uid, visible, state.active,
                                        self.background,
                                        level_scale_gate=gate)
        return out

    # ------------------------------------------------------------------
    def state_to_numpy(self, state: ScaffoldState) -> List[np.ndarray]:
        return scaffold_state_to_numpy(state)

    def state_from_numpy(self, leaves) -> ScaffoldState:
        return scaffold_state_from_numpy(leaves, self.device)

    def save_gaussians(self, state: ScaffoldState, path: str):
        self.gaussians.save_ply(state, path)
        self.gaussians.save_mlp_checkpoints(
            state, path.replace(".ply", "_mlp.npz"))

    def load_gaussians(self, path: str) -> ScaffoldState:
        state = self.gaussians.load_ply(path, self.device)
        mlp_path = path.replace(".ply", "_mlp.npz")
        if os.path.exists(mlp_path):
            state = self.gaussians.load_mlp_checkpoints(state, mlp_path)
        return state
