"""Octree-GS with its neural gaussians rendered as 2DGS surfels (port of
gssr_tpu/scene/octree_2dgs.py): the octree scene's LOD anchors with the
surfel render and losses of scene/scaffold_2dgs.py::AnchorSurfels."""
from __future__ import annotations

import dataclasses

from gssr_tpu_torch.scene.octree import OctreeScene, OctreeSceneConfig
from gssr_tpu_torch.scene.scaffold_2dgs import AnchorSurfels


@dataclasses.dataclass
class Octree2DGSSceneConfig(OctreeSceneConfig):
    lambda_dist: float = 0.0
    lambda_normal: float = 0.05
    depth_ratio: float = 0.0


class Octree2DGSScene(AnchorSurfels, OctreeScene):
    config: Octree2DGSSceneConfig
