"""Band (tile-row) sharding for the rasterizers (port of
gssr_tpu/ops/band.py).

One image's tile rows are split into horizontal bands, one per rank. The
full-frame preprocess (gaussian-sized, cheap) runs replicated; binning
and the blend kernel (instance- and pixel-sized, the cost) run on the
rank's band alone; the band maps are gathered back (parallel/comm.py::
gather_bands), so every loss sees the full frame and needs no halo.

Gradients: the loss is computed replicated after the gather; the
gather's backward hands each rank its band's cotangent, and the sum of
the per-gaussian gradients over the ranks is the exact single-device
gradient (the scenes' gradient merge).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from gssr_tpu_torch.ops.binning import Binning, bin_gaussians
from gssr_tpu_torch.ops.projection import MASK_TILES, TILE, _popcount32
from gssr_tpu_torch.parallel import comm

_U32 = 0xFFFFFFFF


def band_ty0(rank: int, band_ty: int) -> int:
    """The first tile row of rank's band."""
    return rank * band_ty


def band_rows(ph: int, band_rank: Optional[int], band_count: int
              ) -> Tuple[int, int]:
    """(tile rows, first tile row) of rank band_rank's band of a padded
    image ph pixels high; the whole frame when band_rank is None."""
    rows = ph // TILE
    if band_rank is None:
        return rows, 0
    if rows % band_count:
        raise ValueError(f"{rows} tile rows do not divide into "
                         f"{band_count} bands")
    band_ty = rows // band_count
    return band_ty, band_ty0(band_rank, band_ty)


def check_modes(band_rank: Optional[int], gauss_shard: bool) -> None:
    if band_rank is not None and gauss_shard:
        raise ValueError("gaussian sharding and band sharding are mutually "
                         "exclusive")


def _to_i32(u):
    """int64 holding a uint32 value -> int32 with the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def clip_to_band(rect, tiles_full, tile_mask, ty0: int, band_ty: int
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor], torch.Tensor]:
    """Clip tile rects to rows [ty0, ty0 + band_ty) and rebase them to
    band-local rows. Returns (rect_band, tiles_band, mask_band,
    exact_band), exact_band being the exact valid-instance count in the
    band (the popcount of the clipped in-window mask plus the area beyond
    the window).

    tiles_full gates culled gaussians: a culled rect may still have area
    (tile_rect clamps, it does not collapse), so the band area inherits
    the full-frame tiles_touched == 0 cull.

    The intersect mask covers the first 32 rect tiles in row-major order;
    dropping r0 leading rows shifts the enumeration by r0 * w bits. Bits
    shifted in from beyond the 32-tile window are set (those rect
    positions were hits unconditionally in the full-frame enumeration),
    so the clipped mask never drops a hit tile. The uint32 arithmetic of
    the reference runs here in int64."""
    x0, y0f, x1, y1f = rect[:, 0], rect[:, 1], rect[:, 2], rect[:, 3]
    y0 = torch.clamp(y0f, ty0, ty0 + band_ty)
    y1 = torch.clamp(y1f, ty0, ty0 + band_ty)
    rect_band = torch.stack([x0, y0 - ty0, x1, y1 - ty0], dim=1)
    tiles_band = torch.where(tiles_full > 0, (x1 - x0) * (y1 - y0),
                             0).to(torch.int32)

    mask_band = None
    if tile_mask is not None:
        w = torch.clamp(x1 - x0, min=1)
        sh = ((y0 - y0f) * w).to(torch.int64)          # dropped leading bits
        m = tile_mask.to(torch.int64) & _U32
        shifted = torch.where(sh >= 32, 0, m >> torch.clamp(sh, 0, 31))
        keep = 32 - sh                                 # surviving window bits
        ones = torch.full_like(keep, _U32)
        fill = torch.where(
            keep <= 0, _U32,
            torch.where(keep >= 32, 0,
                        (ones << torch.clamp(keep, 0, 31)) & _U32))
        mask_band = _to_i32(shifted | fill)

    if mask_band is None:
        exact_band = tiles_band
    else:
        window = torch.clamp(tiles_band, max=MASK_TILES).to(torch.int64)
        keep_bits = torch.where(
            window >= 32, _U32,
            (torch.ones_like(window) << torch.clamp(window, 0, 31)) - 1)
        in_window = _popcount32(
            _to_i32((mask_band.to(torch.int64) & _U32) & keep_bits))
        exact_band = torch.where(
            tiles_band > 0,
            in_window + torch.clamp(tiles_band - MASK_TILES, min=0),
            0).to(torch.int32)
    return rect_band, tiles_band, mask_band, exact_band


def shift_mean2d(mean2d, ty0: int):
    """Screen positions in band-local pixel coordinates."""
    return mean2d - torch.tensor([0.0, float(ty0 * TILE)],
                                 dtype=mean2d.dtype, device=mean2d.device)


def rebase_tmat(Tmat, ty0: int):
    """The surfel's homogeneous splat-to-pixel map [N, 3, 3] (rows Tu, Tv,
    Tw) projected to band-local rows: y_local = y - ty0 * TILE, so
    Tv_local = Tv - (ty0 * TILE) * Tw. Without it the surfel kernels
    intersect rays at the wrong rows and still produce an image."""
    dy = float(ty0 * TILE)
    return torch.stack([Tmat[..., 0, :],
                        Tmat[..., 1, :] + -dy * Tmat[..., 2, :],
                        Tmat[..., 2, :]], dim=-2)


def bin_band(rect, depth, tiles, tile_mask, mean2d, pw: int, ph: int,
             band_rank: Optional[int], band_count: int, chunk: int):
    """The binning of rank band_rank's band of a pw x ph padded frame (the
    whole frame when band_rank is None) and mean2d in the band's pixel
    rows: (binning, mean2d, band tile rows, first tile row). The sort key
    keeps the frame's tile bits, so the band's instances sort as the
    frame's do."""
    tiles_y, ty0 = band_rows(ph, band_rank, band_count)
    if band_rank is not None:
        rect, tiles, tile_mask, _ = clip_to_band(rect, tiles, tile_mask, ty0,
                                                 tiles_y)
        mean2d = shift_mean2d(mean2d, ty0)
    binning = bin_gaussians(rect, depth, tiles, pw // TILE, tiles_y,
                            tile_mask, chunk=chunk,
                            key_tiles=(pw // TILE) * (ph // TILE))
    return binning, mean2d, tiles_y, ty0


def gather_band(rows, binning: Binning):
    """A band's maps [band_h, W, C] gathered into the frame's, with the
    instance count and overflow flag over the bands."""
    return (comm.gather_bands(rows),
            *merge_flags(binning.num_rendered, binning.overflow))


def merge_flags(num_rendered, overflow):
    """The instance count over the bands (sum) and the overflow flag
    (any); the port's overflow is always false."""
    total = comm.all_reduce(num_rendered.reshape(1), "sum")[0]
    over = comm.all_reduce(overflow.reshape(1).to(torch.int32), "max")[0]
    return total, over > 0
