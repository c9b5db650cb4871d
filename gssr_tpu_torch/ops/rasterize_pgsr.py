"""Differentiable planar (PGSR) rasterization, single device (port of
gssr_tpu/ops/rasterize_pgsr.py):

  preprocess (autograd, the vanilla one with its tile mask)
    -> planar geometry (autograd): smallest-axis normal with a
       camera-facing flip, camera-space normal, plane distance
    -> binning (detached index math)
    -> instance pack (backward: deterministic segment sum)
    -> planar blend (CUDA kernels in a torch.autograd.Function)
    -> plane depth distance / -(n . ray + 1e-8) from the blended maps
       (autograd)

Three zero-valued hooks read statistics from the backward: the gradient
of `mean2d_offset` is dL/dmean2d, that of `mean2d_abs_offset` the sums of
|dL/dmean2d| over pixels, and that of `observe_offset` the per-gaussian
observe counts (the backward kernel writes them whatever the cotangent).
A render that returns `observe` as a forward output launches the observe
kernel; a training render passes forward_observe=False and reads the
counts from the gradient of `observe_offset` instead.

Band mode is ops/rasterize.py's (there is no gaussian sharding for the
planar payload, as in gssr_tpu): the observe counts are band-partial, so
the forward ones are summed over the ranks here and the backward's by the
scene's gradient merge.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gssr_tpu_torch.ops import band as band_ops
from gssr_tpu_torch.ops import sh as sh_ops
from gssr_tpu_torch.ops.blend import CHUNK, segment_sum_sorted
from gssr_tpu_torch.ops.blend_pgsr import PlanarMaps, blend_pgsr
from gssr_tpu_torch.ops.projection import TILE, preprocess
from gssr_tpu_torch.ops.rasterize import pad_to_tiles
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.utils.general import quat_to_rotmat


class RenderPGSROutput(NamedTuple):
    image: torch.Tensor          # [H,W,3] with the background composited
    final_T: torch.Tensor        # [H,W]
    alpha: torch.Tensor          # [H,W] 1 - final_T
    normal: torch.Tensor         # [H,W,3] blended camera-space normal
    distance: torch.Tensor       # [H,W] blended plane distance
    plane_depth: torch.Tensor    # [H,W]
    observe: Optional[torch.Tensor]  # [N] observe counts, None unless asked
    radii: torch.Tensor          # [N] int32
    mean2d: torch.Tensor         # [N,2]
    num_rendered: torch.Tensor   # [] int32
    overflow: torch.Tensor       # [] bool, always false (exact sizing)


def gaussian_plane_normals(means3d, scales, rotations, campos):
    """World-space normal along each gaussian's smallest scale axis,
    flipped to face the camera. argmin takes the first of equal scales."""
    R = quat_to_rotmat(rotations)                     # [N,3,3]
    idx = torch.argmin(scales, dim=-1)
    normal = torch.gather(R, 2, idx[:, None, None].expand(-1, 3, 1))[..., 0]
    flip = (normal * (campos - means3d)).sum(-1) < 0.0
    return torch.where(flip[:, None], -normal, normal)


def planar_geometry(means3d, scales, rotations, camera):
    """Per gaussian, its plane in camera space: the normal [N,3] and the
    distance of the plane from the camera centre [N]."""
    normal_w = gaussian_plane_normals(means3d, scales, rotations,
                                      camera.campos)
    normal_c = normal_w @ camera.w2c[:3, :3].T
    pts_cam = torch.cat([means3d, torch.ones_like(means3d[..., :1])],
                        -1) @ camera.w2c[:3, :].T
    return normal_c, (normal_c * pts_cam).sum(-1).abs()


def pixel_rays(camera, H: int, W: int, device):
    """Per-pixel camera-space ray components (x - cx) / fx, (y - cy) / fy
    as two [H, W] tensors (the ray's z is 1)."""
    xs = (torch.arange(W, dtype=torch.float32, device=device) - camera.cx) \
        / camera.fx
    ys = (torch.arange(H, dtype=torch.float32, device=device) - camera.cy) \
        / camera.fy
    ry, rx = torch.meshgrid(ys, xs, indexing="ij")
    return rx, ry


def plane_depth_map(normal, distance, camera):
    """Per-pixel depth of the blended plane: distance / -(n . ray + 1e-8)."""
    rx, ry = pixel_rays(camera, *distance.shape, distance.device)
    denom = -(normal[..., 0] * rx + normal[..., 1] * ry + normal[..., 2]
              + 1e-8)
    return distance / denom


def planar_outputs(maps: PlanarMaps, camera, width: int, height: int,
                   bg) -> dict:
    """The maps of RenderPGSROutput from the blend's padded maps, cropped
    to width x height, in autograd: the background composite, alpha and
    the plane depth."""
    def crop(x):
        return x[:height, :width]
    final_T = crop(maps.final_T)
    normal = crop(maps.normal)
    distance = crop(maps.distance)
    return dict(image=crop(maps.color) + final_T[..., None] * bg,
                final_T=final_T, alpha=1.0 - final_T, normal=normal,
                distance=distance,
                plane_depth=plane_depth_map(normal, distance, camera))


def rasterize_pgsr(means3d, scales, rotations, opacity, camera, width: int,
                   height: int, bg, sh_coeffs=None, sh_degree: int = 0,
                   colors_precomp=None, active_mask=None,
                   scaling_modifier: float = 1.0, mean2d_offset=None,
                   mean2d_abs_offset=None, observe_offset=None,
                   forward_observe: bool = True, band_rank=None,
                   band_count: int = 1) -> RenderPGSROutput:
    """Render gaussians with their planar maps through one camera (a
    CameraArrays).

    means3d [N,3], scales [N,3] (activated), rotations [N,4] quaternions,
    opacity [N] (activated). Exactly one of sh_coeffs [N,K,3] and
    colors_precomp [N,3]. The maps are rendered on the TILE-padded grid
    and cropped to width x height. mean2d_offset, mean2d_abs_offset [N,2]
    and observe_offset [N,1] are zero tensors whose gradients carry the
    statistics of the module docstring. `observe` is None unless
    forward_observe. band_rank / band_count: the module docstring's band
    mode."""
    pw, ph = pad_to_tiles(width, height)
    opacity = opacity.reshape(-1)
    proj = preprocess(means3d, scales, rotations, camera, pw, ph, opacity,
                      scaling_modifier=scaling_modifier,
                      active_mask=active_mask)
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    if mean2d_abs_offset is None:
        mean2d_abs_offset = torch.zeros_like(proj.mean2d)
    if observe_offset is None:
        observe_offset = torch.zeros_like(proj.mean2d[:, :1])
    if colors_precomp is not None:
        color = colors_precomp
    else:
        color = sh_ops.sh_to_color(sh_degree, sh_coeffs, means3d,
                                   camera.campos)

    normal_c, distance = planar_geometry(means3d, scales, rotations, camera)
    binning, mean2d, tiles_y, _ = band_ops.bin_band(
        proj.rect, proj.depth.detach(), proj.tiles_touched, proj.tile_mask,
        mean2d, pw, ph, band_rank, band_count, CHUNK)
    maps = blend_pgsr(mean2d, proj.conic, color, opacity, normal_c, distance,
                      observe_offset, mean2d_abs_offset, binning, pw,
                      tiles_y * TILE, forward_observe=forward_observe)
    observe = None
    if forward_observe:
        # per-gaussian sums of the slot counts; fillers reduce to nothing
        observe = segment_sum_sorted(maps.observe_inst[:, None],
                                     binning.gid_reduce,
                                     binning.seg_bounds)[:, 0]
    num_rendered, overflow = binning.num_rendered, binning.overflow
    if band_rank is not None:
        rows, num_rendered, overflow = band_ops.gather_band(maps.rows,
                                                            binning)
        maps = PlanarMaps(rows)
        if observe is not None:
            observe = comm.all_reduce(observe)
    return RenderPGSROutput(
        **planar_outputs(maps, camera, width, height, bg), observe=observe,
        radii=proj.radius, mean2d=proj.mean2d,
        num_rendered=num_rendered, overflow=overflow)
