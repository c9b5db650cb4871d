"""Planar (PGSR) blend: forward, forward-only observe count and analytic
backward (port of gssr_tpu/ops/blend_pgsr_pallas.py).

The TPU kernels `_fwdp_kernel`, `_obsp_kernel` and `_bwdp_kernel` become
the CUDA kernels of csrc/blend_pgsr.cu; beside each is its plain PyTorch
version (`blend_pgsr_fwd_plain`, `blend_pgsr_obs_plain`,
`blend_pgsr_bwd_plain`), which the wrappers take for CPU tensors only. On a
CUDA tensor a wrapper launches its kernel, through the launch layer that
the blend families share (ops/blend_launch.py), or raises.

Layouts:
* instance attributes [NUM_ATTRS_P, I], attribute-major: rows 0-5 the
  vanilla layout (mean2d, conic, opacity; the alpha is the vanilla
  blend's), 6-8 rgb, 9-11 camera-space normal, 12 plane distance, and
  three zero input rows 13-15 whose gradients the backward fills with the
  per-instance observe count and the sums of |d mean2d x|, |d mean2d y|.
  Their gather-VJP columns carry these to the per-gaussian level through
  the one segment sum the real gradients pay for anyway;
* `ranges` [T+1] int32, chunk-aligned per-tile starts (ops/binning.py);
* blend output [H, W, OUTP_ROWS] over the tile-padded image: rows 0-2
  colour, 3-5 normal, 6 distance (the 7 blended channels), 7 `final_T`,
  the product over contributing instances only. The backward's cotangent
  has the same layout.

Semantics per pixel, instances front to back: the vanilla alpha and
transmittance walk (ops/blend.py); the observe count of an instance is
the number of pixels where it contributes while D, the transmittance
before it, is still > 0.5.
"""
from __future__ import annotations

import torch

from gssr_tpu_torch.ops.binning import Binning
from gssr_tpu_torch.ops.blend import (
    ALPHA_MAX,
    ATTR_CXX,
    ATTR_CXY,
    ATTR_CYY,
    CHUNK,
    _chunk_alpha,
    _chunks,
    _GatherRows,
    _image_to_tiles,
    _pixel_coords,
    _tiles_to_image,
    _walk,
)
from gssr_tpu_torch.ops.blend2d import _tile_batches
from gssr_tpu_torch.ops.blend_launch import TileBlend, TileKernels
from gssr_tpu_torch.ops.projection import TILE

P_RGB = 6         # 6-8
P_NRM = 9         # 9-11 camera-space normal
P_DIST = 12       # plane distance
P_OBS = 13        # zero input; the backward writes observe counts here
P_ABSX, P_ABSY = 14, 15   # zero inputs; the backward writes |d mean2d|
LIVE_ATTRS_P = 13
NUM_ATTRS_P = 16
NCH = 7           # blended channels: attribute rows 6-12

PO_RGB = 0        # 0-2
PO_NRM = 3        # 3-5
PO_DIST = 6
PO_T = 7
OUTP_ROWS = 8

# kernel launches since the last reset (the CPU plain path is not counted)
LAUNCHES = {"blend_pgsr_fwd": 0, "blend_pgsr_obs": 0, "blend_pgsr_bwd": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions: vectorised over tiles, looping over chunk index
# ---------------------------------------------------------------------------

def _fwdp_tiles(attrs, ranges, px, py):
    """Forward of a run of tiles -> [T, PIX, OUTP_ROWS]."""
    D = torch.ones_like(px)            # transmittance over all alpha > 0
    Tb = torch.ones_like(px)           # product over contributing only
    acc = torch.zeros(px.shape + (NCH,), device=px.device)
    for A, _, _ in _chunks(attrs, ranges):
        a, _ = _chunk_alpha(A, px, py)
        one_m, _, contrib, w, D = _walk(a, D)
        acc = acc + torch.einsum("tpi,cti->tpc", w, A[P_RGB:P_DIST + 1])
        Tb = Tb * torch.where(contrib, one_m, 1.0).prod(-1)
    return torch.cat([acc, Tb[..., None]], dim=-1)


def blend_pgsr_fwd_plain(attrs, ranges, tiles_x: int, tiles_y: int):
    """Plain version of the forward kernel. Returns [H, W, OUTP_ROWS]."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    attrs = attrs[:LIVE_ATTRS_P]
    out = torch.cat([_fwdp_tiles(attrs, ranges[t0:t1 + 1], px[t0:t1],
                                 py[t0:t1])
                     for t0, t1 in _tile_batches(tiles_x * tiles_y)])
    return _tiles_to_image(out, tiles_x, tiles_y).contiguous()


def _observed(contrib, d_before):
    """1 where an instance contributes while D is still > 0.5."""
    return (contrib & (d_before > 0.5)).float()


def blend_pgsr_obs_plain(attrs, ranges, tiles_x: int, tiles_y: int):
    """Plain version of the observe kernel: per instance slot [I], the
    pixels where it contributes while D > 0.5."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    obs = attrs.new_zeros(attrs.shape[1])
    geom = attrs[:P_RGB]
    for t0, t1 in _tile_batches(tiles_x * tiles_y):
        D = torch.ones_like(px[t0:t1])
        for A, idx, live in _chunks(geom, ranges[t0:t1 + 1]):
            a, _ = _chunk_alpha(A, px[t0:t1], py[t0:t1])
            _, d_before, contrib, _, D = _walk(a, D)
            obs[idx[live]] = _observed(contrib, d_before).sum(1)[live]
    return obs


def _bwdp_tiles(attrs, ranges, fwd, cot, px, py, dattrs):
    """Backward of a run of tiles; writes their instances' rows of
    dattrs."""
    dch = cot[..., :NCH]
    bgterm = fwd[..., PO_T] * cot[..., PO_T]
    # sum_i w_i (payload_i . dch) is the forward's channels contracted
    # with their cotangents: read it instead of walking the list twice
    total = (fwd[..., :NCH] * dch).sum(-1)
    D = torch.ones_like(px)
    prefix = torch.zeros_like(px)
    for A, idx, live in _chunks(attrs, ranges):
        a, (dx, dy, g_exp, raw, ok) = _chunk_alpha(A, px, py)
        one_m, d_before, contrib, w, D = _walk(a, D)
        u = torch.einsum("tpc,cti->tpi", dch, A[P_RGB:P_DIST + 1])
        prefix_inc = prefix[..., None] + torch.cumsum(w * u, dim=-1)
        suffix = total[..., None] - prefix_inc
        da = torch.where(contrib, d_before * u
                         - (suffix + bgterm[..., None]) / one_m, 0.0)
        da = torch.where(ok & (raw < ALPHA_MAX), da, 0.0)
        dpower = da * raw
        cxx, cxy, cyy = (A[i][:, None, :] for i in (ATTR_CXX, ATTR_CXY,
                                                    ATTR_CYY))
        gx = dpower * -(cxx * dx + cxy * dy)
        gy = dpower * -(cyy * dy + cxy * dx)
        rows = torch.stack([
            gx.sum(1), gy.sum(1),
            (dpower * (-0.5 * dx * dx)).sum(1),
            (dpower * (-dx * dy)).sum(1),
            (dpower * (-0.5 * dy * dy)).sum(1),
            (da * g_exp).sum(1),
        ] + list(torch.einsum("tpc,tpi->cti", dch, w)) + [
            _observed(contrib, d_before).sum(1),
            gx.abs().sum(1), gy.abs().sum(1),
        ])                                          # [16, T, CHUNK]
        dattrs[:, idx[live]] = rows[:, live]
        prefix = prefix_inc[..., -1]


def blend_pgsr_bwd_plain(attrs, ranges, fwd_out, cot, tiles_x: int,
                         tiles_y: int):
    """Plain version of the backward kernel: d(attrs) [NUM_ATTRS_P, I] from
    the forward output and its cotangent (both [H, W, OUTP_ROWS]), with the
    observe counts and abs screen gradients in rows 13-15."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    fwd = _image_to_tiles(fwd_out, tiles_x, tiles_y)
    cot = _image_to_tiles(cot, tiles_x, tiles_y)
    dattrs = torch.zeros_like(attrs)
    live_attrs = attrs[:LIVE_ATTRS_P]
    for t0, t1 in _tile_batches(tiles_x * tiles_y):
        _bwdp_tiles(live_attrs, ranges[t0:t1 + 1], fwd[t0:t1], cot[t0:t1],
                    px[t0:t1], py[t0:t1], dattrs)
    return dattrs


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_TILES = TileKernels("blend_pgsr", NUM_ATTRS_P, OUTP_ROWS,
                     "planar blend maps", LAUNCHES)


def blend_pgsr_fwd(attrs, ranges, tiles_x: int, tiles_y: int):
    """Forward planar blend -> [H, W, OUTP_ROWS]."""
    return _TILES.forward(blend_pgsr_fwd_plain, attrs, ranges, tiles_x,
                          tiles_y)


def blend_pgsr_observe(attrs, ranges, tiles_x: int, tiles_y: int):
    """Forward-only observe count per instance slot -> [I]."""
    return _TILES.observe(blend_pgsr_obs_plain, attrs, ranges, tiles_x,
                          tiles_y)


def blend_pgsr_bwd(attrs, ranges, fwd_out, cot, tiles_x: int, tiles_y: int):
    """Backward planar blend -> d(attrs) [NUM_ATTRS_P, I], rows 13-15 the
    observe counts and abs screen gradients."""
    return _TILES.backward(blend_pgsr_bwd_plain, attrs, ranges, fwd_out, cot,
                           tiles_x, tiles_y)


def pack_instance_attrs_pgsr(mean2d, conic, color, opacity, normal, distance,
                             obs_dummy, abs_dummy, binning: Binning):
    """Gather per-gaussian attributes into the sorted-instance layout
    [NUM_ATTRS_P, I]. obs_dummy [N, 1] and abs_dummy [N, 2] are zeros whose
    gradients receive the per-gaussian observe counts and abs screen
    gradients. The hit multiply zeroes filler and non-hit slots, and
    symmetrically their gradients."""
    per_gauss = torch.cat([mean2d, conic, opacity[:, None], color, normal,
                           distance[:, None], obs_dummy, abs_dummy], dim=1)
    live = _GatherRows.apply(per_gauss, binning.gauss_id, binning.hit,
                             binning.slot_pos, binning.seg_bounds)
    return live.T.contiguous()


class PlanarMaps:
    """Column views of the blended output [H, W, OUTP_ROWS], and the
    forward observe count per instance slot [I] where it was asked for
    (the reference's row 0 of its [8, I] observe output), else None."""

    def __init__(self, rows, observe_inst=None):
        self.rows = rows
        self.color = rows[..., PO_RGB:PO_RGB + 3]
        self.final_T = rows[..., PO_T]
        self.normal = rows[..., PO_NRM:PO_NRM + 3]
        self.distance = rows[..., PO_DIST]
        self.observe_inst = observe_inst


def blend_pgsr(mean2d, conic, color, opacity, normal, distance, obs_dummy,
               abs_dummy, binning: Binning, width: int, height: int,
               forward_observe: bool = True) -> PlanarMaps:
    """Blend the sorted instances over a tile-padded image. The observe
    kernel runs only with `forward_observe`: a training render reads the
    counts from the backward's side channel instead (obs_dummy's
    gradient)."""
    assert width % TILE == 0 and height % TILE == 0
    tiles_x, tiles_y = width // TILE, height // TILE
    attrs = pack_instance_attrs_pgsr(mean2d, conic, color, opacity, normal,
                                     distance, obs_dummy, abs_dummy, binning)
    rows = TileBlend.apply(blend_pgsr_fwd, blend_pgsr_bwd, None,
                           torch.Tensor.contiguous, attrs,
                           binning.tile_ranges, tiles_x, tiles_y)
    obs = None
    if forward_observe:
        obs = blend_pgsr_observe(attrs.detach(), binning.tile_ranges,
                                 tiles_x, tiles_y)
    return PlanarMaps(rows, obs)
