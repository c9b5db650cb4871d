"""Tile blend, forward and analytic backward (port of the main-path code of
gssr_tpu/ops/blend_pallas.py).

The two TPU kernels `_fwd_kernel` and `_bwd_kernel` become the CUDA
kernels of csrc/blend.cu; beside each is its plain PyTorch version
(`blend_fwd_plain`, `blend_bwd_plain`), which the wrappers take for CPU
tensors only. On a CUDA tensor a wrapper launches its kernel or raises.
`blend_bwd_v1` launches the backward's first design, kept as the yardstick
of the current one; no render calls it.

Layouts:
* instance attributes [NUM_ATTRS, I], attribute-major, 9 live rows
  (mx, my, cxx, cxy, cyy, op, r, g, b) and zero rows 9-15; filler and
  non-hit slots are all-zero columns, which blend as exact alpha = 0
  no-ops and receive zero gradient;
* `ranges` [T+1] int32, chunk-aligned per-tile starts (ops/binning.py);
* blend output [H, W, 4] over the tile-padded image: rows 0-2 the
  accumulated colour, row 3 `final_T`, the transmittance product over
  contributing instances only. The backward's cotangent has the same
  layout.

Semantics per pixel, instances front to back: alpha = min(0.99,
op * exp(power)), zero unless power <= 0 and alpha >= 1/255; T_all is
multiplied by (1 - alpha) for every alpha > 0 instance; an instance
contributes w = alpha * T_before only while T_all * (1 - alpha) >= 1e-4.

The per-gaussian reduction of the instance gradients (the gather's
backward) is a sorted segment sum, so gradients are reproducible run to
run: no atomics anywhere on the path.
"""
from __future__ import annotations

import ctypes

import torch

from gssr_tpu_torch.ops import _kernels
from gssr_tpu_torch.ops.binning import Binning
from gssr_tpu_torch.ops.projection import TILE

ATTR_MX, ATTR_MY = 0, 1
ATTR_CXX, ATTR_CXY, ATTR_CYY = 2, 3, 4
ATTR_OP = 5
ATTR_R, ATTR_G, ATTR_B = 6, 7, 8
LIVE_ATTRS = 9
NUM_ATTRS = 16

OUT_ROWS = 4          # 0-2 accumulated colour, 3 final_T
PIX = TILE * TILE     # 256 pixels per tile
CHUNK = 128           # instances per chunk; binning pads ranges to this

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

# kernel launches since the last reset (the CPU plain path is not counted)
LAUNCHES = {"blend_fwd": 0, "blend_bwd": 0, "blend_bwd_v1": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions: vectorised over tiles, looping over chunk index
# ---------------------------------------------------------------------------

def _pixel_coords(tiles_x: int, tiles_y: int, device):
    """Pixel centres of every tile as [T, PIX] float x and y."""
    t = torch.arange(tiles_x * tiles_y, device=device)
    sub = torch.arange(PIX, device=device)
    px = ((t % tiles_x)[:, None] * TILE + sub % TILE).float()
    py = ((t // tiles_x)[:, None] * TILE + sub // TILE).float()
    return px, py


def _chunks(attrs, ranges):
    """Yield (A [NUM_ATTRS, T, CHUNK], idx [T, CHUNK], live [T]) for each
    chunk index; tiles with fewer chunks get all-zero (no-op) columns."""
    start = ranges[:-1].long()
    nch = (ranges[1:] - ranges[:-1]).long() // CHUNK
    lane = torch.arange(CHUNK, device=attrs.device)
    for k in range(int(nch.max()) if nch.numel() else 0):
        live = k < nch
        idx = torch.where(live[:, None], start[:, None] + k * CHUNK + lane, 0)
        A = torch.where(live[None, :, None], attrs[:, idx], 0.0)
        yield A, idx, live


def _chunk_alpha(A, px, py):
    """Per-(tile, pixel, instance) alpha [T, PIX, CHUNK], zero wherever
    the blend skips, plus the intermediates the backward chains through."""
    def r(i):
        return A[i][:, None, :]
    dx = r(ATTR_MX) - px[..., None]
    dy = r(ATTR_MY) - py[..., None]
    power = -0.5 * (r(ATTR_CXX) * dx * dx + r(ATTR_CYY) * dy * dy) \
        - r(ATTR_CXY) * dx * dy
    g_exp = torch.exp(power)
    raw = r(ATTR_OP) * g_exp
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(ok, alpha, 0.0), (dx, dy, g_exp, raw, ok)


def _walk(a, D):
    """One chunk of the front-to-back recurrence, for all tiles at once:
    T before each instance, its contributing mask and blend weight, and T
    after the chunk. T is multiplied one instance at a time, in the
    kernels' order (a prefix product would round differently), so on the
    card the T_EPS decisions here are the kernels' own, bit for bit."""
    one_m = 1.0 - a
    d_before = []
    for i in range(a.shape[-1]):
        d_before.append(D)
        D = D * one_m[..., i]          # exact no-op where alpha is 0
    d_before = torch.stack(d_before, dim=-1)
    contrib = (a > 0.0) & (d_before * one_m >= T_EPS)
    w = torch.where(contrib, a * d_before, 0.0)
    return one_m, d_before, contrib, w, D


def _tiles_to_image(x, tiles_x: int, tiles_y: int):
    """[T, PIX, C] -> [H, W, C]."""
    c = x.shape[-1]
    x = x.reshape(tiles_y, tiles_x, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return x.reshape(tiles_y * TILE, tiles_x * TILE, c)


def _image_to_tiles(x, tiles_x: int, tiles_y: int):
    """[H, W, C] -> [T, PIX, C]."""
    c = x.shape[-1]
    x = x.reshape(tiles_y, TILE, tiles_x, TILE, c).permute(0, 2, 1, 3, 4)
    return x.reshape(tiles_y * tiles_x, PIX, c)


def blend_fwd_plain(attrs, ranges, tiles_x: int, tiles_y: int):
    """Plain version of the forward kernel. Returns [H, W, 4]."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    D = torch.ones_like(px)            # transmittance over all alpha > 0
    Tb = torch.ones_like(px)           # product over contributing only
    acc = torch.zeros(px.shape + (3,), device=attrs.device)
    for A, _, _ in _chunks(attrs, ranges):
        a, _ = _chunk_alpha(A, px, py)
        one_m, _, contrib, w, D = _walk(a, D)
        acc = acc + torch.einsum("tpi,cti->tpc", w, A[ATTR_R:ATTR_B + 1])
        Tb = Tb * torch.where(contrib, one_m, 1.0).prod(-1)
    out = torch.cat([acc, Tb[..., None]], dim=-1)
    return _tiles_to_image(out, tiles_x, tiles_y).contiguous()


def blend_bwd_plain(attrs, ranges, fwd_out, cot, tiles_x: int, tiles_y: int):
    """Plain version of the backward kernel: d(attrs) [NUM_ATTRS, I] from
    the forward output and its cotangent (both [H, W, 4])."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    fwd = _image_to_tiles(fwd_out, tiles_x, tiles_y)
    cot = _image_to_tiles(cot, tiles_x, tiles_y)
    dacc = cot[..., :3]
    bgterm = fwd[..., 3] * cot[..., 3]
    # sum_i w_i (colour_i . dacc) is the forward colour contracted with
    # its cotangent: read it instead of walking the list twice
    total = (fwd[..., :3] * dacc).sum(-1)
    D = torch.ones_like(px)
    prefix = torch.zeros_like(px)
    dattrs = torch.zeros_like(attrs)
    for A, idx, live in _chunks(attrs, ranges):
        a, (dx, dy, g_exp, raw, ok) = _chunk_alpha(A, px, py)
        one_m, d_before, contrib, w, D = _walk(a, D)
        u = torch.einsum("tpc,cti->tpi", dacc, A[ATTR_R:ATTR_B + 1])
        prefix_inc = prefix[..., None] + torch.cumsum(w * u, dim=-1)
        suffix = total[..., None] - prefix_inc
        da = torch.where(contrib, d_before * u
                         - (suffix + bgterm[..., None]) / one_m, 0.0)
        da = torch.where(ok & (raw < ALPHA_MAX), da, 0.0)
        dpower = da * raw
        cxx, cxy, cyy = (A[i][:, None, :] for i in (ATTR_CXX, ATTR_CXY,
                                                    ATTR_CYY))
        rows = torch.stack([
            (dpower * -(cxx * dx + cxy * dy)).sum(1),
            (dpower * -(cyy * dy + cxy * dx)).sum(1),
            (dpower * (-0.5 * dx * dx)).sum(1),
            (dpower * (-dx * dy)).sum(1),
            (dpower * (-0.5 * dy * dy)).sum(1),
            (da * g_exp).sum(1),
        ] + list(torch.einsum("tpc,tpi->cti", dacc, w)))    # [9, T, CHUNK]
        dattrs[:LIVE_ATTRS, idx[live]] = rows[:, live]
        prefix = prefix_inc[..., -1]
    return dattrs


def blend_pair_count(attrs, ranges, tiles_x: int, tiles_y: int):
    """The work of a blend on these inputs: (pairs, contributing). `pairs`
    are the (pixel, instance) pairs it must evaluate, per pixel its tile's
    instances up to the one at which the pixel's transmittance has fallen
    below T_EPS; `contributing` the pairs among them with a blend weight.
    The kernels evaluate the gaussian per pair and do the rest of their
    arithmetic per contributing pair, so these are the counts their bounds
    rest on. Only rows 0-5 are read, which the planar (PGSR) layout
    shares."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    D = torch.ones_like(px)
    pairs = contributing = 0
    for A, _, live in _chunks(attrs[:ATTR_R], ranges):
        a, _ = _chunk_alpha(A, px, py)
        _, d_before, contrib, _, D = _walk(a, D)
        pairs += int(((d_before >= T_EPS) & live[:, None, None]).sum())
        contributing += int(contrib.sum())
    return pairs, contributing


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_inputs(attrs, ranges, tiles_x: int, tiles_y: int, *maps):
    if attrs.dtype != torch.float32 or attrs.dim() != 2 \
            or attrs.shape[0] != NUM_ATTRS or attrs.shape[1] % CHUNK:
        raise ValueError(f"attrs must be float32 [{NUM_ATTRS}, I] with I a "
                         f"multiple of {CHUNK}, got {attrs.dtype} "
                         f"{tuple(attrs.shape)}")
    if ranges.dtype != torch.int32 \
            or ranges.shape != (tiles_x * tiles_y + 1,):
        raise ValueError("ranges must be int32 [tiles + 1]")
    shape = (tiles_y * TILE, tiles_x * TILE, OUT_ROWS)
    for m in maps:
        if m.dtype != torch.float32 or tuple(m.shape) != shape:
            raise ValueError(f"blend maps must be float32 {shape}")
    for x in (attrs, ranges) + maps:
        if x.device != attrs.device or not x.is_contiguous():
            raise ValueError("blend inputs must be contiguous, one device")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def blend_fwd(attrs, ranges, tiles_x: int, tiles_y: int):
    """Forward tile blend -> [H, W, 4] (colour, final_T)."""
    if attrs.device.type == "cpu":
        return blend_fwd_plain(attrs, ranges, tiles_x, tiles_y)
    _check_inputs(attrs, ranges, tiles_x, tiles_y)
    out = torch.empty((tiles_y * TILE, tiles_x * TILE, OUT_ROWS),
                      dtype=torch.float32, device=attrs.device)
    _kernels.launch("gssr_blend_fwd", attrs.device, _ptr(attrs),
                    ctypes.c_int64(attrs.shape[1]), _ptr(ranges),
                    ctypes.c_int(tiles_x), ctypes.c_int(tiles_y), _ptr(out))
    LAUNCHES["blend_fwd"] += 1
    return out


def _bwd(kernel: str, attrs, ranges, fwd_out, cot, tiles_x: int,
         tiles_y: int):
    if attrs.device.type == "cpu":
        return blend_bwd_plain(attrs, ranges, fwd_out, cot, tiles_x, tiles_y)
    _check_inputs(attrs, ranges, tiles_x, tiles_y, fwd_out, cot)
    # chunks past a tile's saturation and rows 9-15 stay zero
    dattrs = torch.zeros_like(attrs)
    _kernels.launch(f"gssr_{kernel}", attrs.device, _ptr(attrs),
                    ctypes.c_int64(attrs.shape[1]), _ptr(ranges),
                    ctypes.c_int(tiles_x), ctypes.c_int(tiles_y),
                    _ptr(fwd_out), _ptr(cot), _ptr(dattrs))
    LAUNCHES[kernel] += 1
    return dattrs


def blend_bwd(attrs, ranges, fwd_out, cot, tiles_x: int, tiles_y: int):
    """Backward tile blend -> d(attrs) [NUM_ATTRS, I]."""
    return _bwd("blend_bwd", attrs, ranges, fwd_out, cot, tiles_x, tiles_y)


def blend_bwd_v1(attrs, ranges, fwd_out, cot, tiles_x: int, tiles_y: int):
    """The same through the first backward kernel, the yardstick of the
    current one; no render calls it."""
    return _bwd("blend_bwd_v1", attrs, ranges, fwd_out, cot, tiles_x,
                tiles_y)


class _BlendCore(torch.autograd.Function):
    """Forward kernel in forward, backward kernel in backward."""

    @staticmethod
    def forward(ctx, attrs, ranges, tiles_x: int, tiles_y: int):
        out = blend_fwd(attrs, ranges, tiles_x, tiles_y)
        ctx.save_for_backward(attrs, ranges, out)
        ctx.tiles = (tiles_x, tiles_y)
        return out[..., :3].contiguous(), out[..., 3].contiguous()

    @staticmethod
    def backward(ctx, d_img, d_T):
        attrs, ranges, out = ctx.saved_tensors
        cot = torch.cat([d_img, d_T[..., None]], dim=-1).contiguous()
        return blend_bwd(attrs, ranges, out, cot, *ctx.tiles), None, None, None


# ---------------------------------------------------------------------------
# Instance gather with a deterministic per-gaussian reduction
# ---------------------------------------------------------------------------

def segment_sum_sorted(vals, gid_reduce, seg_bounds, block: int = CHUNK):
    """Per-gaussian sums of per-slot values [I, C] -> [N, C], without
    atomics. A stable sort by gaussian id puts gaussian g's slots at
    [seg_bounds[g], seg_bounds[g+1]); sentinel slots (id N) sort last.
    Each sum is the difference of a float64 prefix sum at the two bounds
    (as in gssr_tpu's segment_reduce_sorted), built in two levels: scans
    within `block`-slot blocks, then over the block totals. Every scan
    has a fixed summation order, so the result is the same on every run,
    and float64 keeps it exact to float32 rounding."""
    i_cap, c = vals.shape
    assert i_cap % block == 0, "slot count must be block-aligned"
    order = torch.sort(gid_reduce, stable=True).indices
    within = torch.cumsum(vals[order].double().T.reshape(c, -1, block), -1)
    blockpre = torch.cumsum(torch.cat([within.new_zeros(c, 1),
                                       within[..., -1]], 1), 1)
    b = seg_bounds.long()
    partial = within.reshape(c, -1)[:, torch.clamp(b - 1, min=0)]
    prefix = blockpre[:, b // block] + torch.where(b % block > 0, partial,
                                                   0.0)
    return (prefix[:, 1:] - prefix[:, :-1]).T.to(vals.dtype)


class _GatherRows(torch.autograd.Function):
    """per_gauss[gauss_id] whose backward is the sorted segment sum."""

    @staticmethod
    def forward(ctx, per_gauss, gauss_id, gid_reduce, seg_bounds):
        ctx.save_for_backward(gid_reduce, seg_bounds)
        return per_gauss[gauss_id.long()]

    @staticmethod
    def backward(ctx, dg):
        gid_reduce, seg_bounds = ctx.saved_tensors
        return segment_sum_sorted(dg, gid_reduce, seg_bounds), None, None, None


def pack_instance_attrs(mean2d, conic, color, opacity, binning: Binning):
    """Gather per-gaussian attributes into the sorted-instance layout
    [NUM_ATTRS, I]. The hit multiply zeroes filler / non-hit slots, and
    symmetrically their gradients."""
    per_gauss = torch.cat([mean2d, conic, opacity[:, None], color], dim=1)
    g = _GatherRows.apply(per_gauss, binning.gauss_id, binning.gid_reduce,
                          binning.seg_bounds)
    live = (g * binning.hit[:, None]).T
    return torch.cat([live, live.new_zeros(NUM_ATTRS - LIVE_ATTRS,
                                           live.shape[1])]).contiguous()


def blend(mean2d, conic, color, opacity, binning: Binning, width: int,
          height: int, bg):
    """Blend the sorted instances into a tile-padded image.
    Returns (image [H,W,3] with the background composited, final_T [H,W])."""
    assert width % TILE == 0 and height % TILE == 0
    tiles_x, tiles_y = width // TILE, height // TILE
    attrs = pack_instance_attrs(mean2d, conic, color, opacity, binning)
    acc, final_T = _BlendCore.apply(attrs, binning.tile_ranges, tiles_x,
                                    tiles_y)
    return acc + final_T[..., None] * bg, final_T
