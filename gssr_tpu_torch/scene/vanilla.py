"""Vanilla 3DGS scene: render + L1/D-SSIM losses + train step, one device
(port of gssr_tpu/scene/vanilla.py).

A train step renders through the CUDA blend kernels, differentiates the
loss with autograd (the blend's backward is the hand-written backward
kernel), applies Adam and accumulates the densification statistics.
Densification and opacity reset run on their schedule after the step.
The reference's multi-device modes and K-step scan blocks have no
counterpart here: the first wait for the scale-out slice, the second was
a workaround for XLA dispatch cost that eager PyTorch does not pay.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import field
from typing import Dict, List, Optional

import numpy as np
import torch

from gssr_tpu_torch.cameras import Camera
from gssr_tpu_torch.configs.base import DataLoaderConfig
from gssr_tpu_torch.dataio.dataset import ColmapDataLoader
from gssr_tpu_torch.models.convert import state_from_numpy, state_to_numpy
from gssr_tpu_torch.models.vanilla import (
    PARAM_NAMES,
    GaussianState,
    VanillaGaussianConfig,
    VanillaGaussians,
)
from gssr_tpu_torch.ops.rasterize import rasterize
from gssr_tpu_torch.ops.ssim import l1_loss, psnr, ssim

GT_CACHE_FRAMES = 64


@dataclasses.dataclass
class VanillaSceneConfig:
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    gaussians: VanillaGaussianConfig = field(
        default_factory=VanillaGaussianConfig)
    lambda_dssim: float = 0.2
    random_background: bool = False
    scaling_modifier: float = 1.0


class VanillaScene:
    def __init__(self, config: VanillaSceneConfig, source_dir: str, device,
                 eval: bool = False, seed: int = 0,
                 dataloader: Optional[ColmapDataLoader] = None):
        self.config = config
        self.device = torch.device(device)
        self.dataloader = dataloader or ColmapDataLoader(
            config.dataloader, source_dir, eval, seed=seed)
        self.cameras_extent = self.dataloader.cameras_extent
        self.background = torch.as_tensor(self.dataloader.background,
                                          device=self.device)
        self.gaussians = self.make_gaussians()
        pcd = self.dataloader.point_cloud
        self.state = self.gaussians.create_from_points(
            pcd.points, pcd.colors, self.device)
        cam0 = self.dataloader.train_cameras[0]
        self.width, self.height = cam0.width, cam0.height
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._gt_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()

    def make_gaussians(self) -> VanillaGaussians:
        return VanillaGaussians(self.config.gaussians,
                                spatial_lr_scale=self.cameras_extent)

    # ------------------------------------------------------------------
    def render_params(self, params, camera, sh_degree: int, active, bg,
                      mean2d_offset=None):
        g = self.gaussians
        return rasterize(
            params["xyz"], g.get_scaling(params), g.get_rotation(params),
            g.get_opacity(params)[:, 0], camera, self.width, self.height, bg,
            sh_coeffs=g.get_features(params), sh_degree=sh_degree,
            active_mask=active, scaling_modifier=self.config.scaling_modifier,
            mean2d_offset=mean2d_offset)

    def loss_terms(self, out, gt, step: int, camera):
        """Method losses of a render; `camera` (CameraArrays) is the one
        it came from. Subclasses extend them."""
        lam = self.config.lambda_dssim
        return {
            "L1_loss": (1.0 - lam) * l1_loss(out.image, gt),
            "ssim_loss": lam * (1.0 - ssim(out.image, gt)),
        }

    def gt_device(self, camera: Camera) -> torch.Tensor:
        """The camera's GT frame on the device, through a bounded LRU so
        a frame is uploaded once, not every step."""
        key = (camera.uid, np.shape(camera.image))
        v = self._gt_cache.pop(key, None)
        if v is None:
            v = torch.as_tensor(np.asarray(camera.image, np.float32),
                                device=self.device)
        self._gt_cache[key] = v
        while len(self._gt_cache) > GT_CACHE_FRAMES:
            self._gt_cache.popitem(last=False)
        return v

    def get_background(self):
        if self.config.random_background:
            return torch.rand(3, generator=self.generator, device=self.device)
        return self.background

    # ------------------------------------------------------------------
    def train_step(self, state: GaussianState, camera: Camera, step: int):
        """One step: render, loss, backward, Adam, densify statistics.
        Returns (new state, metrics as 0-d tensors)."""
        g = self.gaussians
        sh_degree = g.active_sh_degree(step)
        cam = camera.arrays(self.device)
        gt = self.gt_device(camera)
        bg = self.get_background()
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        m2d_offset = torch.zeros_like(state.params["xyz"][:, :2],
                                      requires_grad=True)
        out = self.render_params(params, cam, sh_degree, state.active, bg,
                                 mean2d_offset=m2d_offset)
        terms = self.loss_terms(out, gt, step, cam)
        loss = sum(terms.values())
        inputs = [params[k] for k in PARAM_NAMES] + [m2d_offset]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(inputs, grads)]
        with torch.no_grad():
            new_state = g.adam_step(state, dict(zip(PARAM_NAMES, grads)),
                                    g.learning_rates(step))
            new_state.stats = g.update_stats(
                state.stats, out.radii, grads[-1],
                g.ndc_grad_scale(self.width, self.height, self.device))
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics.update(loss=loss.detach(), num_rendered=out.num_rendered,
                       overflow=out.overflow)
        return new_state, metrics

    # ------------------------------------------------------------------
    def densify(self, state: GaussianState, step: int,
                noise=None) -> GaussianState:
        """Densify/prune and opacity reset on the reference's schedule.
        `noise` replaces the model's position samples, [2, C, 3] for the
        split children here (tests inject the reference's draw)."""
        cfg = self.config.gaussians
        if step >= cfg.densify_until_iter:
            return state
        with torch.no_grad():
            if step > cfg.densify_from_iter and \
                    step % cfg.densification_interval == 0:
                state = self.densify_and_prune(
                    state, step > cfg.opacity_reset_interval, noise)
            if step % cfg.opacity_reset_interval == 0:
                state = self.gaussians.reset_opacity(state)
        return state

    def densify_and_prune(self, state: GaussianState, use_size_prune: bool,
                          noise=None) -> GaussianState:
        return self.gaussians.densify_and_prune(
            state, use_size_prune, generator=self.generator, noise=noise)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_render(self, state: GaussianState, camera: Camera, step: int):
        return self.render_params(
            state.params, camera.arrays(self.device),
            self.gaussians.active_sh_degree(step), state.active,
            self.background)

    def evaluate(self, state: GaussianState, step: int) -> Dict[str, float]:
        cams = self.dataloader.test_cameras or \
            self.dataloader.train_cameras[:8]
        l1s, psnrs = [], []
        for cam in cams:
            out = self.eval_render(state, cam, step)
            gt = torch.as_tensor(np.asarray(cam.image, np.float32),
                                 device=self.device)
            l1s.append(float(l1_loss(out.image, gt)))
            psnrs.append(float(psnr(out.image, gt)))
        return {"eval_l1": float(np.mean(l1s)),
                "eval_psnr": float(np.mean(psnrs))}

    # ------------------------------------------------------------------
    def aux_arrays(self) -> List[np.ndarray]:
        """Scene state beyond the gaussians that rides in checkpoints, in
        the reference's aux order: RNG state, sampler draws."""
        return [self.generator.get_state().numpy(),
                np.asarray(self.dataloader.draws)]

    def restore_aux(self, aux: List[np.ndarray]):
        rng, draws = aux
        if rng.dtype == np.uint8:
            self.generator.set_state(torch.as_tensor(rng))
        else:
            # a gssr_tpu checkpoint holds a JAX key, which no torch
            # generator can reproduce: seed from its words instead
            words = np.asarray(rng, np.uint64).ravel()
            self.generator.manual_seed(int(words[0]) << 32 | int(words[-1]))
        self.dataloader.restore_sampler(int(draws))

    def state_to_numpy(self, state: GaussianState) -> List[np.ndarray]:
        """The state's leaves in gssr_tpu's checkpoint order."""
        return state_to_numpy(state)

    def state_from_numpy(self, leaves) -> GaussianState:
        return state_from_numpy(leaves, self.device)

    def save_gaussians(self, state: GaussianState, path: str):
        self.gaussians.save_ply(state, path)

    def load_gaussians(self, path: str) -> GaussianState:
        return self.gaussians.load_ply(path, self.device)
