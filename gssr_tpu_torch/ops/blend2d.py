"""2DGS surfel blend, forward and analytic backward (port of
gssr_tpu/ops/blend2d_pallas.py).

The TPU kernels `_fwd2_kernel` and `_bwd2_kernel` become the CUDA kernels
of csrc/blend2d.cu; beside each is its plain PyTorch version
(`blend2d_fwd_plain`, `blend2d_bwd_plain`), which the wrappers take for
CPU tensors only. On a CUDA tensor a wrapper launches its kernel, through
the launch layer that the blend families share (ops/blend_launch.py), or
raises. `surfel_cull_plain` is the plain version of the forward kernel's cull,
the test that skips a pair whose alpha is provably 0 before its divisions
and exp.

Layouts:
* instance attributes [NUM_ATTRS2, I], attribute-major, 21 live rows
  (mean2d xy, CA, CB, CC, Tw, opacity, rgb, normal) and zero rows 21-23.
  The ray-splat intersection s = cross(px Tw - Tu, py Tw - Tv) expands to
  CA - px CB - py CC with the per-splat invariants CA = Tu x Tv,
  CB = Tw x Tv, CC = Tu x Tw, packed once per splat; autograd routes
  their gradients back to the T matrix. Filler and non-hit slots are
  all-zero columns: pz = 0 fails the intersection gate, so they blend as
  exact alpha = 0 no-ops and receive zero gradient;
* `ranges` [T+1] int32, chunk-aligned per-tile starts (ops/binning.py);
* blend output [H, W, OUT2_ROWS] over the tile-padded image, rows O_*
  below; the backward's cotangent has the same layout.

Semantics per pixel, instances front to back (2DGS's renderCUDA): alpha =
min(0.99, op * exp(-rho/2)) with rho = min(rho3d, rho2d) (the low-pass
disk), zero unless pz != 0, depth >= 0.2 and alpha >= 1/255; D, the
transmittance over every alpha > 0 instance, decides contribution (w =
alpha * D while D * (1 - alpha) >= 1e-4). The median is the last
contributor with D > 0.5. Distortion is sum_i w_i (m_i^2 A_i + M2_i -
2 m_i M1_i) with exclusive running sums M1 = sum w m, M2 = sum w m^2;
its backward uses the pairwise form through S0 = 1 - final_T and the
totals S1 = M1, S2 = M2 that the forward writes to rows 14-15.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gssr_tpu_torch.ops.binning import Binning
from gssr_tpu_torch.ops.blend import (
    ALPHA_MAX,
    ALPHA_MIN,
    CHUNK,
    T_EPS,
    _GatherRows,
    _chunks,
    _image_to_tiles,
    _pixel_coords,
    _tiles_to_image,
    _walk,
)
from gssr_tpu_torch.ops.blend_launch import TileBlend, TileKernels
from gssr_tpu_torch.ops.projection import TILE
from gssr_tpu_torch.utils.tracing import span

A_XY = 0          # 0-1  mean2d (low-pass centre)
A_CA = 2          # 2-4  Tu x Tv
A_CB = 5          # 5-7  Tw x Tv
A_CC = 8          # 8-10 Tu x Tw
A_TW = 11         # 11-13
A_OP = 14
A_RGB = 15        # 15-17
A_NRM = 18        # 18-20
LIVE_ATTRS2 = 21
NUM_ATTRS2 = 24

O_RGB = 0         # 0-2
O_NRM = 3         # 3-5
O_D = 6           # sum w * depth
O_DIST = 7
O_T = 8           # final_T, the product over contributing instances
O_MED = 9         # median depth
O_SELPOS = 10     # tile-local sorted position of the median, -1 = none
O_MEDNRM = 11     # 11-13 median normal
O_S1 = 14         # sum w * m, for the backward
O_S2 = 15         # sum w * m^2
OUT2_ROWS = 16

NEAR_N = 0.2
FAR_N = 100.0
M_COEF = FAR_N / (FAR_N - NEAR_N)

# the forward kernel's cull (csrc/blend2d.cu): the limit on rho widened by
# this factor and pad, and the floor of the 3D test's bound
CULL_WIDEN = 1.0 + 2.0 ** -10
CULL_PAD = 2.0 ** -10
CULL_FLOOR = 2.0 ** -100

# tiles the plain versions process at once, to bound their memory on the
# card ([tiles, PIX, CHUNK] intermediates)
PLAIN_TILE_BATCH = 1024

# kernel launches since the last reset (the CPU plain path is not counted)
LAUNCHES = {"blend2d_fwd": 0, "blend2d_bwd": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions: vectorised over tiles, looping over chunk index
# ---------------------------------------------------------------------------

class _Surfel(NamedTuple):
    a: torch.Tensor           # [T, PIX, CHUNK] alpha, 0 where skipped
    rpz: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    dx: torch.Tensor          # mean2d - pixel
    dy: torch.Tensor
    is3d: torch.Tensor
    depth: torch.Tensor
    safe_depth: torch.Tensor
    m: torch.Tensor           # distortion's depth map value
    g_exp: torch.Tensor
    raw: torch.Tensor
    ok: torch.Tensor


def _surfel_alpha(A, px, py) -> _Surfel:
    """Per-(tile, pixel, instance) surfel evaluation of one chunk; every
    operation rounds once, as the kernels' _rn intrinsics do."""
    def r(i):
        return A[i][:, None, :]
    px, py = px[..., None], py[..., None]
    p0, p1, p2 = (r(A_CA + j) - px * r(A_CB + j) - py * r(A_CC + j)
                  for j in range(3))
    pz_ok = p2 != 0.0
    rpz = 1.0 / torch.where(pz_ok, p2, 1.0)
    # clipped: degenerate splats otherwise blow up the backward chain
    s0 = torch.clamp(p0 * rpz, -1e4, 1e4)
    s1 = torch.clamp(p1 * rpz, -1e4, 1e4)
    rho3d = s0 * s0 + s1 * s1
    dx = r(A_XY) - px
    dy = r(A_XY + 1) - py
    rho2d = 2.0 * (dx * dx + dy * dy)
    is3d = rho3d <= rho2d
    rho = torch.minimum(rho3d, rho2d)
    tw2 = r(A_TW + 2).expand_as(s0)
    depth = torch.where(is3d, s0 * r(A_TW) + s1 * r(A_TW + 1) + tw2, tw2)
    g_exp = torch.exp(-0.5 * rho)
    raw = r(A_OP) * g_exp
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    ok = pz_ok & (depth >= NEAR_N) & (alpha >= ALPHA_MIN)
    safe_depth = torch.clamp(depth, min=1e-6)
    m = M_COEF * (1.0 - NEAR_N / safe_depth)
    return _Surfel(torch.where(ok, alpha, 0.0), rpz, s0, s1, dx, dy, is3d,
                   depth, safe_depth, m, g_exp, raw, ok)


def cull_limit(op):
    """Per instance, the largest rho at which alpha = op * exp(-rho / 2)
    can reach 1/255, 2 ln(255 op), widened by CULL_WIDEN and CULL_PAD; -1
    where op < 1/255 (fillers included), which no rho reaches."""
    lim = 2.0 * torch.log(255.0 * op) * CULL_WIDEN + CULL_PAD
    return torch.where(op < ALPHA_MIN, -1.0, lim)


def surfel_cull_plain(A, px, py):
    """[T, PIX, CHUNK] bool, True where the forward kernel skips the pair:
    pz = 0, or rho2d > lim and p0^2 + p1^2 > max(lim pz^2, CULL_FLOOR),
    from the intersection p and rho2d as _surfel_alpha rounds them, in the
    kernel's order. The widening dwarfs every rounding on the way, so a
    skipped pair has alpha 0 (csrc/blend2d.cu says why)."""
    def r(i):
        return A[i][:, None, :]
    px, py = px[..., None], py[..., None]
    p0, p1, p2 = (r(A_CA + j) - px * r(A_CB + j) - py * r(A_CC + j)
                  for j in range(3))
    dx = r(A_XY) - px
    dy = r(A_XY + 1) - py
    rho2d = 2.0 * (dx * dx + dy * dy)
    lim = cull_limit(A[A_OP])[:, None, :]
    q = p0 * p0 + p1 * p1
    # fmax, as the kernel's fmaxf, takes the floor where the product is NaN
    bound = torch.fmax(lim * (p2 * p2), q.new_tensor(CULL_FLOOR))
    return (p2 == 0.0) | ((rho2d > lim) & (q > bound))


def _excl_cumsum(x):
    return torch.cumsum(x, -1) - x


def _tile_batches(n_tiles: int):
    for t0 in range(0, n_tiles, PLAIN_TILE_BATCH):
        yield t0, min(t0 + PLAIN_TILE_BATCH, n_tiles)


def _fwd_tiles(attrs, ranges, px, py):
    """Forward of a run of tiles -> [T, PIX, OUT2_ROWS]."""
    D = torch.ones_like(px)            # transmittance over all alpha > 0
    Tb = torch.ones_like(px)           # product over contributing only
    acc6 = torch.zeros(px.shape + (6,), device=px.device)
    dsum, dist, M1, M2, med = (torch.zeros_like(px) for _ in range(5))
    med_n = torch.zeros(px.shape + (3,), device=px.device)
    sel = torch.full_like(px, -1.0)
    lane = torch.arange(CHUNK, device=px.device)
    for k, (A, _, _) in enumerate(_chunks(attrs, ranges)):
        sf = _surfel_alpha(A, px, py)
        one_m, d_before, contrib, w, D = _walk(sf.a, D)
        acc6 = acc6 + torch.einsum("tpi,cti->tpc", w, A[A_RGB:A_NRM + 3])
        dsum = dsum + (w * sf.depth).sum(-1)
        wm = w * sf.m
        wmm = wm * sf.m
        M1_bef = M1[..., None] + _excl_cumsum(wm)
        M2_bef = M2[..., None] + _excl_cumsum(wmm)
        dist = dist + ((sf.m * sf.m * (1.0 - d_before) + M2_bef
                        - 2.0 * sf.m * M1_bef) * w).sum(-1)
        M1 = M1 + wm.sum(-1)
        M2 = M2 + wmm.sum(-1)
        # the median: the chunk's last contributor with D > 0.5 replaces
        # any earlier one
        idx1 = torch.where(contrib & (d_before > 0.5), lane + 1, 0).amax(-1)
        has = idx1 > 0
        j = torch.clamp(idx1 - 1, min=0)
        med = torch.where(has, sf.depth.gather(-1, j[..., None])[..., 0],
                          med)
        nrm = A[A_NRM:A_NRM + 3].permute(1, 2, 0)            # [T, CHUNK, 3]
        picked = nrm.gather(1, j[..., None].expand(-1, -1, 3))
        med_n = torch.where(has[..., None], picked, med_n)
        sel = torch.where(has, (k * CHUNK + idx1 - 1).float(), sel)
        Tb = Tb * torch.where(contrib, one_m, 1.0).prod(-1)
    return torch.cat([acc6, dsum[..., None], dist[..., None], Tb[..., None],
                      med[..., None], sel[..., None], med_n, M1[..., None],
                      M2[..., None]], dim=-1)


def blend2d_fwd_plain(attrs, ranges, tiles_x: int, tiles_y: int):
    """Plain version of the forward kernel. Returns [H, W, OUT2_ROWS]."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    attrs = attrs[:LIVE_ATTRS2]
    out = torch.cat([_fwd_tiles(attrs, ranges[t0:t1 + 1], px[t0:t1],
                                py[t0:t1])
                     for t0, t1 in _tile_batches(tiles_x * tiles_y)])
    return _tiles_to_image(out, tiles_x, tiles_y).contiguous()


def _bwd_tiles(attrs, ranges, fwd, cot, px, py, dattrs):
    """Backward of a run of tiles; writes their instances' rows of
    dattrs."""
    dC = cot[..., O_RGB:O_RGB + 3]
    dN = cot[..., O_NRM:O_NRM + 3]
    dCN = cot[..., O_RGB:O_NRM + 3]
    dD, ddist, dmed = cot[..., O_D], cot[..., O_DIST], cot[..., O_MED]
    dmednrm = cot[..., O_MEDNRM:O_MEDNRM + 3]
    final_T, sel = fwd[..., O_T], fwd[..., O_SELPOS]
    # the totals a first backward pass would rebuild, read from the
    # forward: each base channel is linear in w, so its total is the
    # forward's map contracted with its cotangent
    S0 = 1.0 - final_T
    S1, S2 = fwd[..., O_S1], fwd[..., O_S2]
    total_wb = dD * fwd[..., O_D] + (dCN * fwd[..., O_RGB:O_NRM + 3]).sum(-1) \
        + ddist * 2.0 * (S0 * S2 - S1 * S1)
    bgterm = final_T * cot[..., O_T]
    ex = lambda x: x[..., None]                            # noqa: E731
    D = torch.ones_like(px)
    prefix = torch.zeros_like(px)
    lane = torch.arange(CHUNK, device=px.device)
    for k, (A, idx, live) in enumerate(_chunks(attrs, ranges)):
        sf = _surfel_alpha(A, px, py)
        one_m, d_before, contrib, w, D = _walk(sf.a, D)
        m = sf.m
        base = sf.depth * ex(dD) + torch.einsum(
            "tpc,cti->tpi", dCN, A[A_RGB:A_NRM + 3])
        beta = base + ex(ddist) * (m * m * ex(S0) + ex(S2) - 2.0 * m * ex(S1))
        prefix_inc = ex(prefix) + torch.cumsum(w * beta, -1)
        suffix = ex(total_wb) - prefix_inc
        da = torch.where(contrib, d_before * beta
                         - (suffix + ex(bgterm)) / one_m, 0.0)
        da_eff = torch.where(sf.ok & (sf.raw < ALPHA_MAX), da, 0.0)
        onehot = (ex(sel) >= 0.0) & ((k * CHUNK + lane).float() == ex(sel))
        dm_dd = M_COEF * NEAR_N / (sf.safe_depth * sf.safe_depth)
        gdepth = torch.where(contrib, w * ex(dD) + ex(ddist) * 2.0 * w
                             * (m * ex(S0) - ex(S1)) * dm_dd, 0.0)
        gdepth = gdepth + torch.where(onehot, ex(dmed), 0.0)
        grho = da_eff * -0.5 * sf.raw
        zero = torch.zeros_like(grho)
        g2d = torch.where(sf.is3d, zero, grho)
        g3d = torch.where(sf.is3d, grho, zero)
        tw0, tw1 = A[A_TW][:, None, :], A[A_TW + 1][:, None, :]
        gs0 = g3d * 2.0 * sf.s0 + torch.where(sf.is3d, gdepth * tw0, zero)
        gs1 = g3d * 2.0 * sf.s1 + torch.where(sf.is3d, gdepth * tw1, zero)
        gp = [gs0 * sf.rpz, gs1 * sf.rpz,
              -(sf.s0 * gs0 + sf.s1 * gs1) * sf.rpz]
        pxe, pye = px[..., None], py[..., None]
        rows = ([(g2d * 4.0 * sf.dx).sum(1), (g2d * 4.0 * sf.dy).sum(1)]
                + [g.sum(1) for g in gp]
                + [(-pxe * g).sum(1) for g in gp]
                + [(-pye * g).sum(1) for g in gp]
                + [torch.where(sf.is3d, gdepth * sf.s0, zero).sum(1),
                   torch.where(sf.is3d, gdepth * sf.s1, zero).sum(1),
                   gdepth.sum(1),
                   (da_eff * sf.g_exp).sum(1)]
                + list(torch.einsum("tpc,tpi->cti", dC, w))
                + list(torch.einsum("tpc,tpi->cti", dN, w)
                       + torch.einsum("tpc,tpi->cti", dmednrm,
                                      onehot.float())))
        rows = torch.stack(rows)                            # [21, T, CHUNK]
        dattrs[:LIVE_ATTRS2, idx[live]] = rows[:, live]
        prefix = prefix_inc[..., -1]


def blend2d_bwd_plain(attrs, ranges, fwd_out, cot, tiles_x: int,
                      tiles_y: int):
    """Plain version of the backward kernel: d(attrs) [NUM_ATTRS2, I] from
    the forward output and its cotangent (both [H, W, OUT2_ROWS])."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    fwd = _image_to_tiles(fwd_out, tiles_x, tiles_y)
    cot = _image_to_tiles(cot, tiles_x, tiles_y)
    dattrs = torch.zeros_like(attrs)
    live_attrs = attrs[:LIVE_ATTRS2]
    for t0, t1 in _tile_batches(tiles_x * tiles_y):
        _bwd_tiles(live_attrs, ranges[t0:t1 + 1], fwd[t0:t1], cot[t0:t1],
                   px[t0:t1], py[t0:t1], dattrs)
    return dattrs


def blend2d_pair_count(attrs, ranges, tiles_x: int, tiles_y: int):
    """The work of a surfel blend on these inputs: (pairs, contributing).
    `pairs` are the (pixel, instance) pairs it must evaluate, per pixel its
    tile's instances up to the one at which D has fallen below T_EPS;
    `contributing` the pairs among them with a blend weight. Both kernels
    evaluate the surfel per pair and do the rest of their arithmetic per
    contributing pair, so these are the counts their bounds rest on."""
    px, py = _pixel_coords(tiles_x, tiles_y, attrs.device)
    attrs = attrs[:LIVE_ATTRS2]
    pairs = contributing = 0
    for t0, t1 in _tile_batches(tiles_x * tiles_y):
        D = torch.ones_like(px[t0:t1])
        for A, _, live in _chunks(attrs, ranges[t0:t1 + 1]):
            sf = _surfel_alpha(A, px[t0:t1], py[t0:t1])
            _, d_before, contrib, _, D = _walk(sf.a, D)
            pairs += int(((d_before >= T_EPS) & live[:, None, None]).sum())
            contributing += int(contrib.sum())
    return pairs, contributing


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_TILES = TileKernels("blend2d", NUM_ATTRS2, OUT2_ROWS, "surfel blend maps",
                     LAUNCHES)


def blend2d_fwd(attrs, ranges, tiles_x: int, tiles_y: int):
    """Forward surfel blend -> [H, W, OUT2_ROWS]."""
    return _TILES.forward(blend2d_fwd_plain, attrs, ranges, tiles_x, tiles_y)


def blend2d_bwd(attrs, ranges, fwd_out, cot, tiles_x: int, tiles_y: int):
    """Backward surfel blend -> d(attrs) [NUM_ATTRS2, I]."""
    return _TILES.backward(blend2d_bwd_plain, attrs, ranges, fwd_out, cot,
                           tiles_x, tiles_y)


# output rows that carry no gradient: the median's position is an index,
# and S1/S2 only feed the backward (their effect on the distortion is in
# its analytic chain already)
NO_GRAD_ROWS = (O_SELPOS, O_S1, O_S2)


def _cotangent(g_rows):
    """The backward kernel's cotangent: the maps' with NO_GRAD_ROWS zero."""
    cot = g_rows.clone()
    # the rows' upload and the zero's, each its own host sync
    with span("sync.blend_rows"):
        rows = torch.as_tensor(NO_GRAD_ROWS).to(cot.device)
    with span("sync.blend_rows"):
        cot[..., rows] = 0.0
    return cot.contiguous()


def pack_instance_attrs_2d(mean2d, Tmat, normal, color, opacity,
                           binning: Binning):
    """Gather per-splat attributes into the sorted-instance layout
    [NUM_ATTRS2, I]. The hit multiply zeroes filler slots, and
    symmetrically their gradients."""
    n = mean2d.shape[0]
    T9 = Tmat.reshape(n, 9)
    Tu, Tv, Tw = T9[:, 0:3], T9[:, 3:6], T9[:, 6:9]
    per_gauss = torch.cat([mean2d, torch.linalg.cross(Tu, Tv),
                           torch.linalg.cross(Tw, Tv),
                           torch.linalg.cross(Tu, Tw), Tw, opacity[:, None],
                           color, normal], dim=1)
    g = _GatherRows.apply(per_gauss, binning.gauss_id, binning.gid_reduce,
                          binning.seg_bounds)
    live = (g * binning.hit[:, None]).T
    return torch.cat([live, live.new_zeros(NUM_ATTRS2 - LIVE_ATTRS2,
                                           live.shape[1])]).contiguous()


class SurfelMaps:
    """Column views of the blended output [H, W, OUT2_ROWS]."""

    def __init__(self, rows):
        self.rows = rows
        self.color = rows[..., O_RGB:O_RGB + 3]
        self.final_T = rows[..., O_T]
        self.depth_exp = rows[..., O_D]
        self.normal = rows[..., O_NRM:O_NRM + 3]
        self.dist = rows[..., O_DIST]
        self.median_depth = rows[..., O_MED]
        self.median_normal = rows[..., O_MEDNRM:O_MEDNRM + 3]
        self.median_contrib = rows[..., O_SELPOS]


def blend2d(mean2d, Tmat, normal, color, opacity, binning: Binning,
            width: int, height: int) -> SurfelMaps:
    """Blend the sorted surfel instances over a tile-padded image."""
    assert width % TILE == 0 and height % TILE == 0
    tiles_x, tiles_y = width // TILE, height // TILE
    attrs = pack_instance_attrs_2d(mean2d, Tmat, normal, color, opacity,
                                   binning)
    return SurfelMaps(TileBlend.apply(blend2d_fwd, blend2d_bwd, None,
                                      _cotangent, attrs, binning.tile_ranges,
                                      tiles_x, tiles_y))
