"""PGSR scene: planar rasterization plus multi-view geometric
regularisation, one device (port of gssr_tpu/scene/pgsr.py).

Up to step `multi_view_from` a step renders one camera under L1 + D-SSIM.
After it a step also renders a neighbour camera drawn from the camera's
`near_ids` and adds three losses: the normal consistency of the plane
depth weighted by image gradients, the reprojection (geo) loss of the
plane depth through the neighbour's depth, and the patch NCC of the
reference frame against the neighbour's frame warped by each pixel's
plane homography. Only the reference render feeds the densification
statistics: the abs screen gradients and the observe counts come from the
backward kernel through the render's zero-valued hooks.

The reference's K-step scan blocks have no counterpart here (see
scene/vanilla.py). Its dp and band modes are vanilla.py's, band through
both renders of the two-camera step: the abs screen gradients are
averaged as the others, the band-partial observe counts (which do not
scale with the cotangent) summed over the ranks. A dp step draws a
neighbour for every rank's camera in rank order, as the reference draws
its batch's, and renders its own; gshard is not wired through the PGSR
step (nor is it in gssr_tpu).
"""
from __future__ import annotations

import dataclasses
import random
from collections import OrderedDict
from dataclasses import field
from typing import List

import numpy as np
import torch

from gssr_tpu_torch.dataio.view_selection import assign_near_ids
from gssr_tpu_torch.models.pgsr import (
    EXTRA_NAMES,
    PGSRGaussianConfig,
    PGSRGaussians,
)
from gssr_tpu_torch.models.vanilla import PARAM_NAMES, GaussianState
from gssr_tpu_torch.ops.rasterize_pgsr import pixel_rays, rasterize_pgsr
from gssr_tpu_torch.ops.sampling import (
    bilinear_sample,
    erode,
    image_grad_weight,
    lncc,
    patch_offsets,
    patch_warp,
    rgb_to_gray,
)
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.scene.vanilla import VanillaScene, VanillaSceneConfig
from gssr_tpu_torch.utils.tracing import span

GRAY_CACHE_FRAMES = 32


@dataclasses.dataclass
class PGSRSceneConfig(VanillaSceneConfig):
    gaussians: PGSRGaussianConfig = field(default_factory=PGSRGaussianConfig)
    lambda_normal: float = 0.015
    lambda_ncc: float = 0.15
    lambda_geo: float = 0.03
    patch_size: int = 3
    num_sample: int = 102400
    pixel_noise_threshold: float = 1.0
    num_multi_view: int = 5
    multi_view_from: int = 7000


def _intrinsics(camera, inverse: bool = False):
    """K [3, 3] of a CameraArrays, or its inverse."""
    z, o = torch.zeros_like(camera.fx), torch.ones_like(camera.fx)
    if inverse:
        rows = [[1.0 / camera.fx, z, -camera.cx / camera.fx],
                [z, 1.0 / camera.fy, -camera.cy / camera.fy], [z, z, o]]
    else:
        rows = [[camera.fx, z, camera.cx], [z, camera.fy, camera.cy],
                [z, z, o]]
    return torch.stack([torch.stack(r) for r in rows])


class PGSRScene(VanillaScene):
    config: PGSRSceneConfig

    def __init__(self, config: PGSRSceneConfig, source_dir: str, device,
                 eval: bool = False, seed: int = 0, dataloader=None):
        super().__init__(config, source_dir, device, eval, seed, dataloader)
        try:
            assign_near_ids(self.dataloader.train_cameras, source_dir,
                            num_views=config.num_multi_view)
        except FileNotFoundError:
            pass
        self.extra_stats = self.gaussians.init_extra_stats(
            self.state.active.shape[0], self.device)
        self.seed = seed
        self._near_seed = seed ^ 0x9E3779B9
        self._near_draws = 0
        self._gray_cache: "OrderedDict[int, torch.Tensor]" = OrderedDict()

    def make_gaussians(self):
        return PGSRGaussians(self.config.gaussians,
                             spatial_lr_scale=self.cameras_extent)

    def gshard_capacity(self) -> int:
        raise NotImplementedError(
            "gshard is not wired through the PGSR multi-view step; use dp "
            "or band for the pgsr family")

    # ------------------------------------------------------------------
    def render_params(self, params, camera, sh_degree: int, active, bg,
                      mean2d_offset=None, mean2d_abs_offset=None,
                      observe_offset=None, forward_observe: bool = True,
                      **par):
        g = self.gaussians
        return rasterize_pgsr(
            params["xyz"], g.get_scaling(params), g.get_rotation(params),
            g.get_opacity(params)[:, 0], camera, self.width, self.height, bg,
            sh_coeffs=g.get_features(params), sh_degree=sh_degree,
            active_mask=active, scaling_modifier=self.config.scaling_modifier,
            mean2d_offset=mean2d_offset, mean2d_abs_offset=mean2d_abs_offset,
            observe_offset=observe_offset, forward_observe=forward_observe,
            **par)

    @staticmethod
    def depth_normal(plane_depth, alpha, camera):
        """Normal of the unprojected plane depth in camera space,
        cross(dh, dv), scaled by the detached alpha."""
        H, W = plane_depth.shape
        gx, gy = pixel_rays(camera, H, W, plane_depth.device)
        pts = torch.stack([gx * plane_depth, gy * plane_depth, plane_depth],
                          dim=-1)
        dv = pts[2:, 1:-1] - pts[:-2, 1:-1]
        dh = pts[1:-1, 2:] - pts[1:-1, :-2]
        nrm = torch.linalg.cross(dh, dv)
        nrm = nrm * torch.rsqrt((nrm * nrm).sum(-1, keepdim=True) + 1e-12)
        nrm = torch.nn.functional.pad(nrm, (0, 0, 1, 1, 1, 1))
        return nrm * alpha.detach()[..., None]

    def _ncc_sample(self, HW: int, step: int, device):
        """The NCC's pixel sample: every pixel, or `num_sample` of them
        drawn from a generator seeded by (seed, step) alone, so that a
        resumed run draws the same."""
        S = min(self.config.num_sample, HW)
        if S == HW:
            return torch.arange(HW, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed * 1_000_003 + step)
        return torch.randperm(HW, generator=gen, device=device)[:S]

    def multi_view_terms(self, out, near_out, camera, near_cam, gt,
                         near_gray, step: int):
        """The losses of a two-camera step: the image-gradient weighted
        normal consistency of the reference render, and the geo and NCC
        losses against the neighbour's render and grayscale frame."""
        cfg = self.config
        w_img = torch.clamp(1.0 - image_grad_weight(gt), 0.0, 1.0) ** 5
        dnormal = self.depth_normal(out.plane_depth, out.alpha, camera)
        terms = {"normal_loss": cfg.lambda_normal * (
            erode(w_img) * (dnormal - out.normal).abs().sum(-1)).mean()}
        terms["geo_loss"], terms["ncc_loss"] = self._multi_view_losses(
            out, near_out, camera, near_cam, rgb_to_gray(gt), near_gray,
            step)
        return terms

    def _multi_view_losses(self, out, near_out, camera, near_cam, gt_gray,
                           near_gray, step: int):
        cfg = self.config
        H, W = out.plane_depth.shape
        dev = out.plane_depth.device

        # reprojection consistency through the neighbour's plane depth
        gx, gy = pixel_rays(camera, H, W, dev)
        rays = torch.stack([gx, gy, torch.ones_like(gx)], -1)
        pts_cam = rays * out.plane_depth[..., None]
        c2w_R = camera.w2c[:3, :3].T
        pts_world = pts_cam.reshape(-1, 3) @ c2w_R.T + camera.campos
        pts_near = pts_world @ near_cam.w2c[:3, :3].T + near_cam.w2c[:3, 3]
        zn = pts_near[:, 2]
        zn_safe = torch.where(zn != 0, zn, 1.0)
        px_near = pts_near[:, 0] * near_cam.fx / zn_safe + near_cam.cx
        py_near = pts_near[:, 1] * near_cam.fy / zn_safe + near_cam.cy
        in_bounds = ((px_near > 0) & (px_near < W) & (py_near > 0)
                     & (py_near < H) & (zn > 0.1))
        map_z = bilinear_sample(near_out.plane_depth,
                                torch.stack([px_near, py_near], -1))
        pts_near_re = pts_near / zn_safe[:, None] * map_z[:, None]
        pts_world_re = (pts_near_re - near_cam.w2c[:3, 3]) \
            @ near_cam.w2c[:3, :3]
        pts_view = pts_world_re @ camera.w2c[:3, :3].T + camera.w2c[:3, 3]
        zv = pts_view[:, 2]
        zv_safe = torch.where(zv != 0, zv, 1.0)
        proj_x = pts_view[:, 0] * camera.fx / zv_safe + camera.cx
        proj_y = pts_view[:, 1] * camera.fy / zv_safe + camera.cy
        iy, ix = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        pix = torch.stack([ix, iy], -1).reshape(-1, 2)
        # eps-safe norm: ||.|| has a NaN gradient at exactly 0, and a
        # pixel that reprojects onto itself (a camera drawn as its own
        # neighbour) hits 0 bit-exactly
        diff = torch.stack([proj_x, proj_y], -1) - pix
        noise = torch.sqrt((diff * diff).sum(-1) + 1e-12)
        d_mask = in_bounds & (noise < cfg.pixel_noise_threshold)
        weights = torch.where(d_mask, torch.exp(-noise).detach(), 0.0)
        cnt = torch.clamp(d_mask.float().sum(), min=1.0)
        geo_loss = cfg.lambda_geo * (weights * noise).sum() / cnt

        # patch NCC through each sampled pixel's plane homography
        idx = self._ncc_sample(H * W, step, dev)
        s_mask, s_weights = d_mask[idx], weights[idx]
        patch_px = pix[idx][:, None, :] + patch_offsets(cfg.patch_size,
                                                        dev)[None]
        ref_vals = bilinear_sample(gt_gray, patch_px).detach()
        R_ref, t_ref = camera.w2c[:3, :3], camera.w2c[:3, 3]
        R_near, t_near = near_cam.w2c[:3, :3], near_cam.w2c[:3, 3]
        rel = R_near @ R_ref.T
        t_rel = R_near @ (R_ref.T @ -t_ref) + t_near
        n_ref = out.normal.reshape(-1, 3)[idx]        # camera space
        d_ref = out.distance.reshape(-1)[idx]
        d_safe = torch.where(d_ref.abs() > 1e-8, d_ref, 1e-8)
        Hmat = rel[None] - (t_rel[None, :, None] @ n_ref[:, None, :]) \
            / d_safe[:, None, None]
        Hfull = _intrinsics(near_cam)[None] @ Hmat \
            @ _intrinsics(camera, inverse=True)[None]
        near_vals = bilinear_sample(near_gray, patch_warp(Hfull, patch_px))
        ncc, ncc_mask = lncc(ref_vals, near_vals)
        m = s_mask & ncc_mask
        cntm = torch.clamp(m.float().sum(), min=1.0)
        ncc_loss = cfg.lambda_ncc * torch.where(m, ncc * s_weights,
                                                0.0).sum() / cntm
        return geo_loss, ncc_loss

    # ------------------------------------------------------------------
    def key_host_choice(self, ids):
        """Counter-based seeded neighbour pick, the reference's own: each
        draw is a pure function of (seed, draw index), so a resumed run
        draws the same sequence."""
        r = random.Random(self._near_seed * 1_000_003 + self._near_draws)
        self._near_draws += 1
        return r.choice(list(ids))

    def multi_view(self, cams, step: int) -> bool:
        """Whether the step on `cams` (step_cameras) renders neighbours:
        past multi_view_from, when every camera of the step has one."""
        return step > self.config.multi_view_from and all(
            len(c.near_ids) > 0 for c in cams)

    def near_for(self, cams):
        """A neighbour drawn for each camera of the step `cams`
        (step_cameras), in order: this rank's and its grayscale frame on
        the device, through a bounded LRU so a frame is uploaded once."""
        picks = [self.key_host_choice(c.near_ids) for c in cams]
        near = self.dataloader.train_cameras[
            picks[self.parallel.rank if self.parallel.mode == "dp" else 0]]
        gray = self._gray_cache.pop(near.uid, None)
        if gray is None:
            with span("sync.near_gray"):
                frame = torch.as_tensor(np.asarray(near.image, np.float32),
                                        device=self.device)
            gray = rgb_to_gray(frame)
        self._gray_cache[near.uid] = gray
        while len(self._gray_cache) > GRAY_CACHE_FRAMES:
            self._gray_cache.popitem(last=False)
        return near, gray

    def train_step(self, state: GaussianState, camera, step: int):
        """One step: the reference render (and past multi_view_from a
        neighbour's render), the losses, backward, Adam and the
        statistics, on `camera` (in dp the list of every rank's,
        step_cameras). Returns (new state, metrics as 0-d tensors)."""
        cams, camera = self.step_cameras(camera)
        g = self.gaussians
        sh_degree = g.active_sh_degree(step)
        cam = camera.arrays(self.device)
        gt = self.gt_device(camera)
        bg = self.get_background()
        multi = self.multi_view(cams, step)
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        zeros = state.params["xyz"].new_zeros
        n = state.active.shape[0]
        hooks = [zeros((n, 2)).requires_grad_(True),
                 zeros((n, 2)).requires_grad_(True),
                 zeros((n, 1)).requires_grad_(True)]
        par = self.render_par()
        with span("pgsr.render_and_loss"):
            out = self.render_params(params, cam, sh_degree, state.active,
                                     bg, *hooks, forward_observe=False,
                                     **par)
            with span("pgsr.loss"):
                terms = self.loss_terms(out, gt, step, cam)
            if multi:
                near, near_gray = self.near_for(cams)
                near_cam = near.arrays(self.device)
                with span("pgsr.near_render"):
                    near_out = self.render_params(params, near_cam,
                                                  sh_degree, state.active, bg,
                                                  forward_observe=False,
                                                  **par)
                with span("pgsr.loss"), span("pgsr.multiview"):
                    terms.update(self.multi_view_terms(
                        out, near_out, cam, near_cam, gt, near_gray, step))
            with span("pgsr.loss"):
                loss = sum(terms.values())
        inputs = [params[k] for k in PARAM_NAMES] + hooks
        with span("pgsr.backward"):
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(inputs, grads)]
        grads = (self.merge_grads(grads[:-3])
                 + self.merge_screen_grads(grads[-3:-1])
                 + self.merge_counts(grads[-1:]))
        m2d_g, m2d_abs_g, obs_g = grads[-3:]
        with torch.no_grad():
            with span("pgsr.adam"):
                new_state = g.adam_step(state, dict(zip(PARAM_NAMES, grads)),
                                        g.learning_rates(step))
            with span("pgsr.stats"):
                extra = self.extra_stats
                new_state.stats, self.extra_stats = g.update_stats_pgsr(
                    state.stats, extra, out.radii, m2d_g, m2d_abs_g,
                    obs_g[:, 0], g.ndc_grad_scale(self.width, self.height,
                                                  self.device))
                if self.parallel.mode == "dp":
                    new_state.stats = g.dp_merge_stats(state.stats,
                                                       new_state.stats)
                    self.extra_stats = g.dp_merge_extra(extra,
                                                        self.extra_stats)
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics.update(loss=loss.detach(), num_rendered=out.num_rendered,
                       overflow=out.overflow)
        return new_state, self.merge_metrics(metrics)

    def merge_counts(self, counts) -> list:
        """The backward's observe counts: band-partial in band mode, and
        independent of the cotangent's scale, so summed over the ranks (the
        reference's psum); a rank's own otherwise."""
        if self.parallel.mode == "band":
            return comm.all_reduce_many(counts)
        return list(counts)

    # ------------------------------------------------------------------
    def densify_and_prune(self, state: GaussianState, use_size_prune: bool,
                          noise=None) -> GaussianState:
        """`noise` [3, C, 3]: the clone's and the two children's samples."""
        state, self.extra_stats = self.gaussians.densify_and_prune(
            state, use_size_prune, self.extra_stats,
            generator=self.generator, noise=noise)
        return state

    @torch.no_grad()
    def eval_render(self, state: GaussianState, camera, step: int):
        """The vanilla eval render through the planar blend. Nothing reads
        an eval or mesh render's observe counts, so it launches no observe
        kernel."""
        return self.render_params(
            state.params, camera.arrays(self.device),
            self.gaussians.active_sh_degree(step), state.active,
            self.background, forward_observe=False)

    def load_gaussians(self, path: str) -> GaussianState:
        state = super().load_gaussians(path)
        self.extra_stats = self.gaussians.init_extra_stats(
            state.active.shape[0], self.device)
        return state

    def aux_arrays(self) -> List[np.ndarray]:
        """The reference's aux order (its dict flattened with sorted keys):
        the extra stats, RNG state, neighbour draws, sampler draws."""
        rng, draws = super().aux_arrays()
        return ([self.extra_stats[k].cpu().numpy() for k in EXTRA_NAMES]
                + [rng, np.asarray(self._near_draws), draws])

    def restore_aux(self, aux: List[np.ndarray]):
        *extra, rng, near_draws, draws = aux
        self.extra_stats = {k: torch.as_tensor(np.asarray(v, np.float32),
                                               device=self.device)
                            for k, v in zip(EXTRA_NAMES, extra)}
        self._near_draws = int(near_draws)
        super().restore_aux([rng, draws])
