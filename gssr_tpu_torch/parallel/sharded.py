"""A banded render without a scene (port of gssr_tpu/parallel/sharded.py).

The multi-device training lives in the scenes (`setup_parallel("dp" |
"band" | "gshard")`, which the trainer calls for `--machine.parallel`).
This is the render-only convenience for evaluation or inference inside a
torch.distributed group: every rank renders the same camera, bins and
blends its tile-row band, and the bands are gathered (ops/band.py).
"""
from __future__ import annotations

from gssr_tpu_torch.ops.rasterize import rasterize
from gssr_tpu_torch.parallel import comm


def build_band_render(width: int, height: int, sh_degree: int = 3):
    """render_fn(means, scales, rots, opac, sh, camera, bg) -> image
    [height, width, 3], to be called on every rank of the group with the
    same inputs: each rank's binning and blend cover its own band."""
    rank, world = comm.rank(), comm.world()

    def render(means, scales, rots, opac, sh, camera, bg):
        return rasterize(means, scales, rots, opac, camera, width, height,
                         bg, sh_coeffs=sh, sh_degree=sh_degree,
                         band_rank=rank, band_count=world).image

    return render
