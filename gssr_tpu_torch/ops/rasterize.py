"""Differentiable gaussian rasterization, single device (port of
gssr_tpu/ops/rasterize.py):

  preprocess (autograd) -> binning (detached index math)
    -> instance gather (backward: deterministic segment sum)
    -> tile blend (CUDA kernels in a torch.autograd.Function)

Screen-space (mean2d) gradients for the densification statistics come
from the zero-valued `mean2d_offset` hook.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gssr_tpu_torch.ops import sh as sh_ops
from gssr_tpu_torch.ops.binning import bin_gaussians
from gssr_tpu_torch.ops.blend import CHUNK, blend
from gssr_tpu_torch.ops.projection import TILE, preprocess


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
              mean2d_offset=None) -> RenderOutput:
    """Render gaussians through one camera (a CameraArrays).

    means3d [N,3], scales [N,3] (activated), rotations [N,4] quaternions,
    opacity [N] (activated). Exactly one of sh_coeffs [N,K,3] and
    colors_precomp [N,3]. The image is rendered on the TILE-padded grid
    and cropped to width x height. mean2d_offset: a zero [N,2] tensor
    whose gradient is dL/dmean2d.
    """
    pw, ph = pad_to_tiles(width, height)
    opacity = opacity.reshape(-1)
    proj = preprocess(means3d, scales, rotations, camera, pw, ph, opacity,
                      scaling_modifier=scaling_modifier,
                      active_mask=active_mask)
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    if colors_precomp is not None:
        color = colors_precomp
    else:
        color = sh_ops.sh_to_color(sh_degree, sh_coeffs, means3d,
                                   camera.campos)

    binning = bin_gaussians(proj.rect, proj.depth.detach(),
                            proj.tiles_touched, pw // TILE, ph // TILE,
                            proj.tile_mask, chunk=CHUNK)
    image, final_T = blend(mean2d, proj.conic, color, opacity, binning,
                           pw, ph, bg)
    return RenderOutput(image=image[:height, :width],
                        final_T=final_T[:height, :width],
                        radii=proj.radius, mean2d=mean2d,
                        num_rendered=binning.num_rendered,
                        overflow=binning.overflow)
