"""Octree-GS with its neural gaussians rendered as PGSR planar splats (port
of gssr_tpu/scene/octree_pgsr.py): the planar anchor step of
scene/scaffold_pgsr.py over the octree scene's LOD anchors, in the
reference's class order. The neighbour's render gets its own LOD mask and
gate through the anchor_level_gate hook."""
from __future__ import annotations

import dataclasses

from gssr_tpu_torch.scene.octree import OctreeScene, OctreeSceneConfig
from gssr_tpu_torch.scene.scaffold_pgsr import ScaffoldPGSRScene


@dataclasses.dataclass
class OctreePGSRSceneConfig(OctreeSceneConfig):
    lambda_normal: float = 0.015
    lambda_ncc: float = 0.15
    lambda_geo: float = 0.03
    patch_size: int = 3
    num_sample: int = 102400
    pixel_noise_threshold: float = 1.0
    num_multi_view: int = 5
    multi_view_from: int = 7000


class OctreePGSRScene(OctreeScene, ScaffoldPGSRScene):
    config: OctreePGSRSceneConfig
