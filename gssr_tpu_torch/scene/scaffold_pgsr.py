"""Scaffold-GS with its neural gaussians rendered as PGSR planar splats
(port of gssr_tpu/scene/scaffold_pgsr.py).

A step renders the decoded gaussians through the planar blend kernels
(ops/rasterize_pgsr.py with precomputed colours, no observe count) under
L1, D-SSIM and the scaffold scaling loss. Past `multi_view_from` a step
also decodes and renders a neighbour camera drawn from the camera's
`near_ids`, with its own prefilter and level gate, and adds PGSR's normal,
geo and NCC losses (scene/pgsr.py, whose helpers this scene borrows as the
reference does). The anchor statistics come from the reference render
alone, and densification stays the anchor scene's.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List

import numpy as np

from gssr_tpu_torch.dataio.view_selection import assign_near_ids
from gssr_tpu_torch.ops.rasterize_pgsr import rasterize_pgsr
from gssr_tpu_torch.scene.pgsr import PGSRScene
from gssr_tpu_torch.scene.scaffold import ScaffoldScene, ScaffoldSceneConfig


@dataclasses.dataclass
class ScaffoldPGSRSceneConfig(ScaffoldSceneConfig):
    lambda_normal: float = 0.015
    lambda_ncc: float = 0.15
    lambda_geo: float = 0.03
    patch_size: int = 3
    num_sample: int = 102400
    pixel_noise_threshold: float = 1.0
    num_multi_view: int = 5
    multi_view_from: int = 7000


class ScaffoldPGSRScene(ScaffoldScene):
    config: ScaffoldPGSRSceneConfig

    def __init__(self, config, source_dir: str, device, eval: bool = False,
                 seed: int = 0, dataloader=None):
        super().__init__(config, source_dir, device, eval, seed, dataloader)
        try:
            assign_near_ids(self.dataloader.train_cameras, source_dir,
                            num_views=config.num_multi_view)
        except FileNotFoundError:
            pass
        self.seed = seed
        self._near_seed = seed ^ 0x9E3779B9
        self._near_draws = 0
        self._gray_cache: "OrderedDict[int, object]" = OrderedDict()

    # the PGSR scene's neighbour draw and multi-view losses
    depth_normal = staticmethod(PGSRScene.depth_normal)
    _ncc_sample = PGSRScene._ncc_sample
    multi_view_terms = PGSRScene.multi_view_terms
    _multi_view_losses = PGSRScene._multi_view_losses
    key_host_choice = PGSRScene.key_host_choice
    near_for = PGSRScene.near_for

    def _rasterize_neural(self, ng, camera, bg, mean2d_offset=None):
        """Nothing reads a render's observe counts here (the anchor
        statistics are the scaffold's), so no render launches the observe
        kernel."""
        return rasterize_pgsr(
            ng.xyz, ng.scaling, ng.rotation, ng.opacity, camera, self.width,
            self.height, bg, colors_precomp=ng.color, active_mask=ng.mask,
            scaling_modifier=self.config.scaling_modifier,
            mean2d_offset=mean2d_offset, forward_observe=False)

    def step_terms(self, state, anchors, mlp, ng, out, gt, bg, step: int,
                   camera, cam) -> Dict[str, object]:
        """L1, D-SSIM and the scaling loss; past multi_view_from, for a
        camera with neighbours, also the normal, geo and NCC losses against
        a drawn neighbour's render of the same anchors and MLP."""
        terms = super().step_terms(state, anchors, mlp, ng, out, gt, bg,
                                   step, camera, cam)
        if step > self.config.multi_view_from and len(camera.near_ids) > 0:
            near, near_gray = self.near_for(camera)
            near_cam = near.arrays(self.device)
            n_visible, n_gate, _ = self.visible_anchors(state, near_cam,
                                                        step)
            _, near_out = self.decode_and_render(
                anchors, mlp, near_cam, near.uid, n_visible, state.active, bg,
                level_scale_gate=n_gate)
            terms.update(self.multi_view_terms(out, near_out, cam, near_cam,
                                               gt, near_gray, step))
        return terms

    def aux_arrays(self) -> List[np.ndarray]:
        """The reference's aux order (its dict flattened with sorted keys):
        RNG state, neighbour draws, sampler draws."""
        rng, draws = super().aux_arrays()
        return [rng, np.asarray(self._near_draws), draws]

    def restore_aux(self, aux: List[np.ndarray]):
        rng, near_draws, draws = aux
        self._near_draws = int(near_draws)
        super().restore_aux([rng, draws])
