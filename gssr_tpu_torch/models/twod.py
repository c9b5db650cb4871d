"""2DGS surfel model (port of gssr_tpu/models/twod.py): two-axis scaling
(disks), split children sampled in the disk plane only, and a higher
opacity cull threshold (0.05)."""
from __future__ import annotations

import dataclasses

from gssr_tpu_torch.models.vanilla import (
    VanillaGaussianConfig,
    VanillaGaussians,
)


@dataclasses.dataclass(frozen=True)
class TwoDGaussianConfig(VanillaGaussianConfig):
    opacity_cull_threshold: float = 0.05


class TwoDGaussians(VanillaGaussians):
    scale_dim = 2

    def split_displacement(self, R, scaling, noise):
        d = noise * scaling                       # [C,2]
        return R[..., :, 0] * d[..., 0:1] + R[..., :, 1] * d[..., 1:2]
