"""Scaffold-GS with its neural gaussians rendered as 2DGS surfels (port of
gssr_tpu/scene/scaffold_2dgs.py).

The decode is the scaffold's; its first two scales span each surfel, which
renders through the surfel blend kernels (ops/rasterize2d.py with
precomputed colours). The losses are the 2DGS regularisers
(scene/twodgs.py::surfel_reg_losses) plus the scaffold scaling loss over
the two scales. AnchorSurfels carries both for the octree variant too.
"""
from __future__ import annotations

import dataclasses

from gssr_tpu_torch.ops.rasterize2d import rasterize_2d
from gssr_tpu_torch.scene.scaffold import ScaffoldScene, ScaffoldSceneConfig
from gssr_tpu_torch.scene.twodgs import surfel_reg_losses


@dataclasses.dataclass
class Scaffold2DGSSceneConfig(ScaffoldSceneConfig):
    lambda_dist: float = 0.0
    lambda_normal: float = 0.05
    depth_ratio: float = 0.0


class AnchorSurfels:
    """The surfel render and losses of an anchor scene (scaffold or
    octree); its config has lambda_dist, lambda_normal and depth_ratio."""

    def _rasterize_neural(self, ng, camera, bg, mean2d_offset=None):
        return rasterize_2d(
            ng.xyz, ng.scaling[:, :2], ng.rotation, ng.opacity, camera,
            self.width, self.height, bg, colors_precomp=ng.color,
            active_mask=ng.mask,
            scaling_modifier=self.config.scaling_modifier,
            depth_ratio=self.config.depth_ratio, mean2d_offset=mean2d_offset)

    def extra_losses(self, ng, out, step: int, camera):
        terms = surfel_reg_losses(out, camera, step,
                                  self.config.lambda_normal,
                                  self.config.lambda_dist)
        terms["scaling_loss"] = self.scaling_loss(ng, dims=2)
        return terms


class Scaffold2DGSScene(AnchorSurfels, ScaffoldScene):
    config: Scaffold2DGSSceneConfig
