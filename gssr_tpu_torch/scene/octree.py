"""Octree-GS scene: the scaffold step with level-of-detail anchor masks
(port of gssr_tpu/scene/octree.py).

Each render narrows the prefilter's visible anchors to its camera's LOD
mask (models/octree.py::pred_int_level) through the scaffold scene's
anchor_level_gate hook; in progressive mode the gate also ramps the
finest level's neural opacity. The init passes the training cameras to
the octree model and sets the progressive schedule; densify grows and
prunes anchors per level on the reference's schedule.
"""
from __future__ import annotations

import dataclasses
from dataclasses import field
from typing import List

import numpy as np
import torch

from gssr_tpu_torch.models.convert import (
    octree_state_from_numpy,
    octree_state_to_numpy,
)
from gssr_tpu_torch.models.octree import (
    OctreeGaussianConfig,
    OctreeGaussians,
    OctreeState,
)
from gssr_tpu_torch.scene.scaffold import ScaffoldScene, ScaffoldSceneConfig


@dataclasses.dataclass
class OctreeSceneConfig(ScaffoldSceneConfig):
    gaussians: OctreeGaussianConfig = field(
        default_factory=OctreeGaussianConfig)
    coarse_iter: int = 10000
    coarse_factor: float = 1.5


class OctreeScene(ScaffoldScene):
    config: OctreeSceneConfig
    SHARDED = ScaffoldScene.SHARDED + ("level", "extra_level")

    def make_gaussians(self) -> OctreeGaussians:
        return OctreeGaussians(
            self.config.gaussians, spatial_lr_scale=self.cameras_extent,
            num_cameras=len(self.dataloader.train_cameras))

    def init_state(self) -> OctreeState:
        pcd = self.dataloader.point_cloud
        state = self.gaussians.create_from_points(
            pcd.points, device=self.device,
            cameras=self.dataloader.train_cameras)
        self.gaussians.set_coarse_interval(self.config.coarse_iter,
                                           self.config.coarse_factor)
        self.init_level_counts = self.gaussians.level_counts(state)
        return state

    def anchor_level_gate(self, state, camera, step, is_training=True):
        return self.gaussians.pred_int_level(state, camera.campos, step,
                                             is_training)

    def densify_due(self, step: int) -> bool:
        return self.config.gaussians.update_anchor and \
            super().densify_due(step)

    def densify(self, state: OctreeState, step: int) -> OctreeState:
        """adjust_anchor_octree on the reference's schedule (it draws
        nothing); anchor_log's entries also hold the active anchors per
        level after it."""
        if self.densify_due(step):
            before = state.active
            with torch.no_grad():
                state = self.gaussians.adjust_anchor_octree(state, step)
            self.anchor_log.append((
                step, int((state.active & ~before).sum()),
                int((before & ~state.active).sum()), int(state.n_active),
                self.gaussians.level_counts(state)))
        return state

    def state_to_numpy(self, state: OctreeState) -> List[np.ndarray]:
        return octree_state_to_numpy(state)

    def state_from_numpy(self, leaves) -> OctreeState:
        return octree_state_from_numpy(leaves, self.device)
