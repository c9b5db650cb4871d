"""Differentiable surfel (2DGS) rasterization, single device (port of
gssr_tpu/ops/rasterize2d.py):

  preprocess_2d (autograd) -> binning (detached index math, no tile mask)
    -> instance pack (backward: deterministic segment sum)
    -> surfel blend (CUDA kernels in a torch.autograd.Function)
    -> derived maps (autograd): world normal, normalised and median depth,
       the depth_ratio mix

Screen-space (mean2d) gradients for the densification statistics come
from the zero-valued `mean2d_offset` hook.

The multi-device branches are ops/rasterize.py's. In band mode the
surfel's homogeneous splat-to-pixel map is rebased to band-local rows
(ops/band.py::rebase_tmat) beside the shifted mean2d; under gaussian
sharding mean2d, the map, normal, depth, rect, tiles, colour and opacity
are gathered.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gssr_tpu_torch.ops import band as band_ops
from gssr_tpu_torch.ops import sh as sh_ops
from gssr_tpu_torch.ops.blend import CHUNK
from gssr_tpu_torch.ops.blend2d import SurfelMaps, blend2d
from gssr_tpu_torch.ops.projection import TILE
from gssr_tpu_torch.ops.projection2d import preprocess_2d
from gssr_tpu_torch.ops.rasterize import pad_to_tiles
from gssr_tpu_torch.parallel import comm


class Render2DOutput(NamedTuple):
    image: torch.Tensor           # [H,W,3] with the background composited
    final_T: torch.Tensor         # [H,W]
    alpha: torch.Tensor           # [H,W]
    normal: torch.Tensor          # [H,W,3] world-space blended normal
    depth_expected: torch.Tensor  # [H,W] alpha-normalised expected depth
    median_depth: torch.Tensor    # [H,W]
    surf_depth: torch.Tensor      # [H,W] depth_ratio mix
    dist: torch.Tensor            # [H,W] distortion map
    median_normal: torch.Tensor   # [H,W,3] camera-space normal of the median
    median_contrib: torch.Tensor  # [H,W] tile-local sorted position of the
                                  # median contributor, -1 = none
    radii: torch.Tensor           # [N] int32
    mean2d: torch.Tensor          # [N,2]
    num_rendered: torch.Tensor    # [] int32
    overflow: torch.Tensor        # [] bool, always false (exact sizing)


def surfel_outputs(maps: SurfelMaps, camera, width: int, height: int, bg,
                   depth_ratio: float) -> dict:
    """The maps of Render2DOutput from the blend's padded maps, cropped to
    width x height, in autograd: the view-to-world normal, alpha-normalised
    expected depth, the NaN-free median depth and the depth_ratio mix."""
    def crop(x):
        return x[:height, :width]
    final_T = crop(maps.final_T)
    alpha = 1.0 - final_T
    opaque = alpha > 1e-6
    depth_expected = torch.where(
        opaque, crop(maps.depth_exp) / torch.where(opaque, alpha, 1.0), 0.0)
    median_depth = torch.nan_to_num(crop(maps.median_depth), 0.0)
    return dict(
        image=crop(maps.color) + final_T[..., None] * bg, final_T=final_T,
        alpha=alpha, normal=crop(maps.normal) @ camera.w2c[:3, :3],
        depth_expected=depth_expected, median_depth=median_depth,
        surf_depth=depth_expected * (1.0 - depth_ratio)
        + depth_ratio * median_depth,
        dist=crop(maps.dist), median_normal=crop(maps.median_normal),
        median_contrib=crop(maps.median_contrib))


def rasterize_2d(means3d, scales2, rotations, opacity, camera, width: int,
                 height: int, bg, sh_coeffs=None, sh_degree: int = 0,
                 colors_precomp=None, active_mask=None,
                 scaling_modifier: float = 1.0, depth_ratio: float = 0.0,
                 mean2d_offset=None, band_rank=None, band_count: int = 1,
                 gauss_shard: bool = False) -> Render2DOutput:
    """Render surfels through one camera (a CameraArrays).

    means3d [N,3], scales2 [N,2] (activated), rotations [N,4] quaternions,
    opacity [N] (activated). Exactly one of sh_coeffs [N,K,3] and
    colors_precomp [N,3]. The maps are rendered on the TILE-padded grid
    and cropped to width x height. mean2d_offset: a zero [N,2] tensor
    whose gradient is dL/dmean2d. band_rank / band_count and gauss_shard:
    ops/rasterize.py's multi-device branches.
    """
    band_ops.check_modes(band_rank, gauss_shard)
    pw, ph = pad_to_tiles(width, height)
    opacity = opacity.reshape(-1)
    proj = preprocess_2d(means3d, scales2, rotations, camera, pw, ph,
                         opacity, scaling_modifier=scaling_modifier,
                         active_mask=active_mask)
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    if colors_precomp is not None:
        color = colors_precomp
    else:
        color = sh_ops.sh_to_color(sh_degree, sh_coeffs, means3d,
                                   camera.campos)

    mean2d_local = mean2d
    Tmat, normal = proj.Tmat, proj.normal
    depth, rect, tiles = proj.depth.detach(), proj.rect, proj.tiles_touched
    if gauss_shard:
        mean2d, Tmat, normal, color, opacity = comm.gather_shard_cols(
            [mean2d, Tmat, normal, color, opacity])
        depth, rect, tiles = comm.all_gather_cols([depth, rect, tiles])
    binning, mean2d, tiles_y, ty0 = band_ops.bin_band(
        rect, depth, tiles, None, mean2d, pw, ph, band_rank, band_count,
        CHUNK)
    if band_rank is not None:
        Tmat = band_ops.rebase_tmat(Tmat, ty0)
    maps = blend2d(mean2d, Tmat, normal, color, opacity, binning, pw,
                   tiles_y * TILE)
    num_rendered, overflow = binning.num_rendered, binning.overflow
    if band_rank is not None:
        rows, num_rendered, overflow = band_ops.gather_band(maps.rows,
                                                            binning)
        maps = SurfelMaps(rows)

    return Render2DOutput(
        **surfel_outputs(maps, camera, width, height, bg, depth_ratio),
        radii=proj.radius, mean2d=mean2d_local,
        num_rendered=num_rendered, overflow=overflow)
