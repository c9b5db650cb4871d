"""Differentiable gaussian rasterization, single device (port of
gssr_tpu/ops/rasterize.py):

  preprocess (autograd) -> binning (detached index math)
    -> instance gather (backward: deterministic segment sum)
    -> tile blend (CUDA kernels in a torch.autograd.Function)

Screen-space (mean2d) gradients for the densification statistics come
from the zero-valued `mean2d_offset` hook. The stages run inside
utils/tracing.py spans: render.preprocess, render.color (SH),
render.binning and render.blend here, render.blend_backward and
render.gather_backward in the backward (ops/blend.py).

Two multi-device branches, one at a time, inside a torch.distributed
group (the scenes' setup_parallel):

* band (`band_rank`, `band_count`): the preprocess runs full-frame and
  replicated; binning and the blend kernel run on the rank's tile-row
  band with band-local rects and mean2d (ops/band.py), and the maps are
  gathered back (parallel/comm.py::gather_bands).
* gaussian sharding (`gauss_shard`): the inputs are this rank's 1/D shard
  of the model; preprocess and SH run on the shard and only the compact
  screen attributes are gathered (parallel/comm.py::gather_shards) into
  the replicated binning and blend. CONTRACT: the loss downstream must be
  computed identically on every rank (a full-frame loss), because
  gather_shards' backward slices a replicated cotangent. The returned
  radii and mean2d stay shard-local, for the densification statistics.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gssr_tpu_torch.ops import band as band_ops
from gssr_tpu_torch.ops import sh as sh_ops
from gssr_tpu_torch.ops.blend import CHUNK, blend
from gssr_tpu_torch.ops.projection import TILE, preprocess
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.utils.tracing import span


def pad_to_tiles(width: int, height: int):
    pw = (width + TILE - 1) // TILE * TILE
    ph = (height + TILE - 1) // TILE * TILE
    return pw, ph


class RenderOutput(NamedTuple):
    image: torch.Tensor          # [H,W,3]
    final_T: torch.Tensor        # [H,W] transmittance after blending
    radii: torch.Tensor          # [N] int32
    mean2d: torch.Tensor         # [N,2] screen positions (differentiable)
    num_rendered: torch.Tensor   # [] int32
    overflow: torch.Tensor       # [] bool, always false (exact sizing)


def rasterize(means3d, scales, rotations, opacity, camera, width: int,
              height: int, bg, sh_coeffs=None, sh_degree: int = 0,
              colors_precomp=None, active_mask=None,
              scaling_modifier: float = 1.0,
              mean2d_offset=None, band_rank=None, band_count: int = 1,
              gauss_shard: bool = False) -> RenderOutput:
    """Render gaussians through one camera (a CameraArrays).

    means3d [N,3], scales [N,3] (activated), rotations [N,4] quaternions,
    opacity [N] (activated). Exactly one of sh_coeffs, the pair (f_dc
    [N,1,3], f_rest [N,K-1,3]) or one [N,K,3] tensor (ops/sh.py::
    sh_to_color), and colors_precomp [N,3]. The image is rendered on the
    TILE-padded grid and
    cropped to width x height. mean2d_offset: a zero [N,2] tensor
    whose gradient is dL/dmean2d. band_rank / band_count and gauss_shard:
    the module docstring's multi-device branches.
    """
    band_ops.check_modes(band_rank, gauss_shard)
    pw, ph = pad_to_tiles(width, height)
    opacity = opacity.reshape(-1)
    with span("render.preprocess"):
        proj = preprocess(means3d, scales, rotations, camera, pw, ph,
                          opacity, scaling_modifier=scaling_modifier,
                          active_mask=active_mask)
        mean2d = proj.mean2d
        if mean2d_offset is not None:
            mean2d = mean2d + mean2d_offset

    if colors_precomp is not None:
        color = colors_precomp
    else:
        with span("render.color"):
            color = sh_ops.sh_to_color(sh_degree, sh_coeffs, means3d,
                                       camera.campos)

    mean2d_local = mean2d
    conic, depth = proj.conic, proj.depth.detach()
    rect, tiles, mask = proj.rect, proj.tiles_touched, proj.tile_mask
    if gauss_shard:
        mean2d, conic, color, opacity = comm.gather_shard_cols(
            [mean2d, conic, color, opacity])
        depth, rect, tiles, mask = comm.all_gather_cols(
            [depth, rect, tiles, mask])
    with span("render.binning"):
        binning, mean2d, tiles_y, _ = band_ops.bin_band(
            rect, depth, tiles, mask, mean2d, pw, ph, band_rank, band_count,
            CHUNK)
    with span("render.blend"):
        image, final_T = blend(mean2d, conic, color, opacity, binning, pw,
                               tiles_y * TILE, bg)
    num_rendered, overflow = binning.num_rendered, binning.overflow
    if band_rank is not None:
        maps, num_rendered, overflow = band_ops.gather_band(
            torch.cat([image, final_T[..., None]], -1), binning)
        image, final_T = maps[..., :3], maps[..., 3]
    return RenderOutput(image=image[:height, :width],
                        final_T=final_T[:height, :width],
                        radii=proj.radius, mean2d=mean2d_local,
                        num_rendered=num_rendered, overflow=overflow)
