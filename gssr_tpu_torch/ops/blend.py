"""Tile blend, forward and analytic backward (port of the main-path code of
gssr_tpu/ops/blend_pallas.py).

The two TPU kernels `_fwd_kernel` and `_bwd_kernel` become the CUDA
kernels of csrc/blend.cu; beside each is its plain PyTorch version
(`blend_fwd_plain`, `blend_bwd_plain`), which the wrappers take for CPU
tensors only. On a CUDA tensor a wrapper launches its kernel, through the
launch layer that the blend families share (ops/blend_launch.py), or
raises. `warp_cull_plain` is the plain version of the forward kernel's
alpha cull (csrc/common.cuh), the test that leaves an instance out of a
warp's walk, and `alpha_cull_plain` the per-pair proof it rests on, which
no kernel runs; both read rows 0-5, which the planar (PGSR) layout
shares.

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

import torch

from gssr_tpu_torch.ops.binning import Binning
from gssr_tpu_torch.ops.blend_launch import CHUNK, TileBlend, TileKernels
from gssr_tpu_torch.ops.projection import TILE
from gssr_tpu_torch.utils.tracing import span

ATTR_MX, ATTR_MY = 0, 1
ATTR_CXX, ATTR_CXY, ATTR_CYY = 2, 3, 4
ATTR_OP = 5
ATTR_R, ATTR_G, ATTR_B = 6, 7, 8
LIVE_ATTRS = 9
NUM_ATTRS = 16

OUT_ROWS = 4          # 0-2 accumulated colour, 3 final_T
PIX = TILE * TILE     # 256 pixels per tile

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

# the forward kernels' alpha cull (csrc/common.cuh): the limit's widening,
# the range of a robust conic and mean, and a warp's pixel block
CULL_REL = 2.0 ** -10
CULL_CONIC_MIN, CULL_CONIC_MAX = 2.0 ** -40, 2.0 ** 40
CULL_MEAN_MAX = 2.0 ** 14
BLOCK_W, BLOCK_H = 8, 4
WARPS = PIX // 32

# kernel launches since the last reset (the CPU plain path is not counted)
LAUNCHES = {"blend_fwd": 0, "blend_bwd": 0}


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


def _power(A, px, py):
    """The gaussian's exponent per (tile, pixel, instance), [T, PIX, CHUNK],
    rounded after every operation as the kernels round it, and dx, dy."""
    def r(i):
        return A[i][:, None, :]
    dx = r(ATTR_MX) - px[..., None]
    dy = r(ATTR_MY) - py[..., None]
    power = -0.5 * (r(ATTR_CXX) * dx * dx + r(ATTR_CYY) * dy * dy) \
        - r(ATTR_CXY) * dx * dy
    return power, dx, dy


def _chunk_alpha(A, px, py):
    """Per-(tile, pixel, instance) alpha [T, PIX, CHUNK], zero wherever
    the blend skips, plus the intermediates the backward chains through."""
    power, dx, dy = _power(A, px, py)
    g_exp = torch.exp(power)
    raw = A[ATTR_OP][:, None, :] * g_exp
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= ALPHA_MIN)
    return torch.where(ok, alpha, 0.0), (dx, dy, g_exp, raw, ok)


def alpha_cull_limit(op):
    """Per instance, the forward kernels' limit on power: L = -ln(255 op)
    moved down by CULL_REL (|L| + 1). +inf where op = 0 (fillers), NaN
    where op is negative or NaN (never culled)."""
    L = -torch.log(255.0 * op)
    return torch.where(L >= 0.0, L * (1.0 - CULL_REL),
                       L * (1.0 + CULL_REL)) - CULL_REL


def alpha_cull_plain(A, px, py):
    """[T, PIX, CHUNK] bool, True where the per-pair proof shows the pair's
    alpha 0: power < lim, from the power _chunk_alpha rounds. The margin
    dwarfs every rounding on the way (csrc/common.cuh says why). No kernel
    evaluates it: it is the lemma under warp_cull_plain, the test the
    forward kernels run, and chip_smoke.py's bounds charge a pair it covers
    in a walked warp step only this test."""
    return _power(A, px, py)[0] < alpha_cull_limit(A[ATTR_OP])[:, None, :]


def warp_blocks(x):
    """[T, PIX, ...] in row-major tile order -> [T, WARPS, 32, ...]: warp w
    of a culling forward covers the 8 x 4 block (w % 2, w // 2) of its
    tile, lane l its pixel (l % 8, l // 8)."""
    t, rest = x.shape[0], x.shape[2:]
    x = x.reshape(t, TILE // BLOCK_H, BLOCK_H, TILE // BLOCK_W, BLOCK_W,
                  *rest)
    return x.transpose(2, 3).reshape(t, WARPS, 32, *rest)


def warp_cull_plain(A, px, py):
    """[T, WARPS, CHUNK] bool, True where warp w of the forward kernel
    leaves the instance out of its walk: Qmin - CULL_REL Emax > -lim over
    its block's pixel-centre rectangle for a robust conic, or lim = +inf
    (csrc/common.cuh::block_culled). Qmin is the exact minimum of the
    convex quadratic there, as ops/projection.py's tile_intersect_mask
    computes it; the kernel may fuse Q's and Emax's products into FMAs,
    which the margin covers as well."""
    def r(i):
        return A[i][:, None, :]
    mx, my, cxx, cxy, cyy = (r(i) for i in (ATTR_MX, ATTR_MY, ATTR_CXX,
                                            ATTR_CXY, ATTR_CYY))
    bx0 = warp_blocks(px).amin(-1)[..., None]
    by0 = warp_blocks(py).amin(-1)[..., None]
    bx1, by1 = bx0 + (BLOCK_W - 1), by0 + (BLOCK_H - 1)
    lim = alpha_cull_limit(r(ATTR_OP))
    robust = ((cxx >= CULL_CONIC_MIN) & (cxx <= CULL_CONIC_MAX)
              & (cyy >= CULL_CONIC_MIN) & (cyy <= CULL_CONIC_MAX)
              & (cxy * cxy < (1.0 - CULL_REL) * cxx * cyy)
              & (mx.abs() < CULL_MEAN_MAX) & (my.abs() < CULL_MEAN_MAX))
    qcut = torch.where(lim == torch.inf, -torch.inf,
                       torch.where(robust, -lim, torch.inf))
    rx = torch.where(robust, cxy / cxx, 0.0)
    ry = torch.where(robust, cxy / cyy, 0.0)

    def q_of(x, y):
        dx, dy = x - mx, y - my
        return 0.5 * (cxx * dx * dx + cyy * dy * dy) + cxy * dx * dy

    q = torch.minimum(
        torch.minimum(q_of(bx0, torch.clamp(my - ry * (bx0 - mx), by0, by1)),
                      q_of(bx1, torch.clamp(my - ry * (bx1 - mx), by0, by1))),
        torch.minimum(q_of(torch.clamp(mx - rx * (by0 - my), bx0, bx1), by0),
                      q_of(torch.clamp(mx - rx * (by1 - my), bx0, bx1), by1)))
    inside = (mx >= bx0) & (mx <= bx1) & (my >= by0) & (my <= by1)
    q = torch.where(inside, 0.0, q)
    X = torch.maximum((bx0 - mx).abs(), (bx1 - mx).abs())
    Y = torch.maximum((by0 - my).abs(), (by1 - my).abs())
    E = 0.5 * (cxx.abs() * X * X + cyy.abs() * Y * Y) + cxy.abs() * X * Y
    return (qcut == -torch.inf) | (q - CULL_REL * E > qcut)


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

_TILES = TileKernels("blend", NUM_ATTRS, OUT_ROWS, "blend maps", LAUNCHES)


def blend_fwd(attrs, ranges, tiles_x: int, tiles_y: int):
    """Forward tile blend -> [H, W, 4] (colour, final_T)."""
    return _TILES.forward(blend_fwd_plain, attrs, ranges, tiles_x, tiles_y)


def blend_bwd(attrs, ranges, fwd_out, cot, tiles_x: int, tiles_y: int):
    """Backward tile blend -> d(attrs) [NUM_ATTRS, I]."""
    return _TILES.backward(blend_bwd_plain, attrs, ranges, fwd_out, cot,
                           tiles_x, tiles_y)


def _split(out):
    """The forward's maps as the render's two outputs: colour, final_T."""
    return out[..., :3].contiguous(), out[..., 3].contiguous()


def _cotangent(d_img, d_T):
    """The backward kernel's cotangent [H, W, 4] from the two outputs'."""
    return torch.cat([d_img, d_T[..., None]], dim=-1).contiguous()


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
        if per_gauss.shape[0] == 0:
            # no gaussian: every slot is a filler, zeroed by its hit
            return per_gauss.new_zeros((gauss_id.shape[0],
                                        per_gauss.shape[1]))
        return per_gauss[gauss_id.long()]

    @staticmethod
    def backward(ctx, dg):
        gid_reduce, seg_bounds = ctx.saved_tensors
        with span("render.gather_backward"):
            d_rows = segment_sum_sorted(dg, gid_reduce, seg_bounds)
        return d_rows, None, None, None


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
    acc, final_T = TileBlend.apply(blend_fwd, blend_bwd, _split, _cotangent,
                                   attrs, binning.tile_ranges, tiles_x,
                                   tiles_y)
    return acc + final_T[..., None] * bg, final_T
