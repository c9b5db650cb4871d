"""The port's surfel blend against gssr_tpu's Pallas surfel kernels
(interpret mode), on the same attribute pack and tile ranges.

blend2d_fwd / blend2d_bwd take their plain versions on the CPU. The
inputs come from gssr_tpu's own preprocess_2d, binning and pack, with an
overdraw stack of nearly-opaque disks so that a tile saturates and pixels
have a median. Tolerances: forward atol 1e-5 / rtol 1e-4, gradients
atol 2e-4 / rtol 2e-3 (tests/test_blend_pallas.py), the median's sorted
position exactly.

The forward kernel's cull must skip only pairs whose alpha is exactly 0:
its plain version, surfel_cull_plain, is held against the plain surfel
evaluation on those scenes and on surfels placed at the alpha = 1/255
edge, exactly.
"""
import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H = 32, 32


def _camera_kwargs(w, h):
    return dict(uid=0, colmap_id=0, image_name="t", R=np.eye(3),
                T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(60),
                fovy=math.radians(60), width=w, height=h)


def _scene(kind, seed=0):
    """numpy surfels (means, scales2, rots, opacity, colors)."""
    rng = np.random.default_rng(seed)
    n = 40
    means = rng.uniform(-1.2, 1.2, (n, 3))
    scales = rng.uniform(0.05, 0.4, (n, 2))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.2, 1.0, n)
    if kind == "overdraw":
        # a stack of camera-facing, nearly-opaque disks in front of one
        # spot: D collapses there (early stop) after a median is found
        k = 24
        means[:k] = np.stack([rng.normal(-0.4, 0.03, k),
                              rng.normal(-0.4, 0.03, k),
                              np.linspace(-1.0, 1.0, k)], 1)
        scales[:k] = rng.uniform(0.3, 0.5, (k, 2))
        rots[:k] = [1.0, 0.0, 0.0, 0.0] + rng.normal(0, 0.05, (k, 4))
        opac[:k] = rng.uniform(0.9, 0.99, k)
    colors = rng.uniform(0, 1, (n, 3))
    f32 = lambda x: np.asarray(x, np.float32)               # noqa: E731
    return tuple(map(f32, (means, scales, rots, opac, colors)))


@functools.lru_cache(maxsize=None)
def _jax_fns(w, h):
    from gssr_tpu.cameras import Camera
    from gssr_tpu.ops.binning import bin_gaussians
    from gssr_tpu.ops.blend2d_pallas import (
        _run_bwd2,
        _run_fwd2,
        pack_instance_attrs_2d,
    )
    from gssr_tpu.ops.projection2d import preprocess_2d
    cam = Camera(**_camera_kwargs(w, h)).arrays()

    @jax.jit
    def pack(means, scales, rots, opac, colors):
        proj = preprocess_2d(means, scales, rots, cam, w, h, opacity=opac)
        b = bin_gaussians(proj.rect, proj.depth, proj.tiles_touched,
                          w // 16, h // 16, 4096, chunk=128)
        attrs = pack_instance_attrs_2d(proj.mean2d, proj.Tmat, proj.normal,
                                       colors, opac, b)
        return attrs, b

    fwd = jax.jit(functools.partial(_run_fwd2, tiles_x=w // 16,
                                    tiles_y=h // 16))
    bwd = jax.jit(functools.partial(_run_bwd2, tiles_x=w // 16,
                                    tiles_y=h // 16))
    return pack, fwd, bwd


@pytest.mark.parametrize("kind", ["cloud", "overdraw"])
def test_plain_blend2d_matches_pallas(kind):
    from gssr_tpu.ops.blend2d_pallas import _rows_to_tiles, _tiles_to_rows
    from gssr_tpu_torch.ops import blend2d as B
    tx, ty = W // 16, H // 16
    pack, fwd, bwd = _jax_fns(W, H)
    attrs, b = pack(*_scene(kind))
    out_j = fwd(attrs, b.tile_ranges)
    rows_j = np.asarray(_tiles_to_rows(out_j, tx, ty))
    cot = np.random.default_rng(5).normal(size=rows_j.shape).astype(
        np.float32)
    d_j = np.asarray(bwd(attrs, b.tile_ranges, b.chunk_map, b.n_live_chunks,
                         out_j, _rows_to_tiles(jnp.asarray(cot), tx, ty)))

    a_t = torch.from_numpy(np.array(attrs))
    r_t = torch.from_numpy(np.array(b.tile_ranges))
    rows_t = B.blend2d_fwd(a_t, r_t, tx, ty)
    sel = B.O_SELPOS
    np.testing.assert_array_equal(rows_t[..., sel].numpy(), rows_j[..., sel])
    keep = [c for c in range(B.OUT2_ROWS) if c != sel]
    np.testing.assert_allclose(rows_t[..., keep].numpy(), rows_j[..., keep],
                               atol=1e-5, rtol=1e-4)
    assert (rows_j[..., sel] >= 0).any()                 # medians exist
    if kind == "overdraw":
        assert rows_j[..., B.O_T].min() < 1e-3           # a tile saturates

    d_t = B.blend2d_bwd(a_t, r_t, rows_t, torch.from_numpy(cot), tx, ty)
    live = B.LIVE_ATTRS2
    assert np.abs(d_j[:live]).max(axis=1).min() > 0      # every row is live
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=2e-4, rtol=2e-3)


def test_blend2d_pair_count_counts_the_walked_pairs():
    """Pairs before saturation: every pixel of an unsaturated tile walks
    all live instances of its tile. The contributing pairs are those with
    a blend weight: 1 - final_T is the sum of their weights."""
    from gssr_tpu_torch.ops import blend2d as B
    pack = _jax_fns(W, H)[0]
    for kind in ("cloud", "overdraw"):
        attrs, b = pack(*_scene(kind))
        a_t = torch.from_numpy(np.array(attrs))
        r_t = torch.from_numpy(np.array(b.tile_ranges))
        counts = np.diff(np.asarray(b.tile_ranges))
        pairs, contributing = B.blend2d_pair_count(a_t, r_t, W // 16,
                                                   H // 16)
        full = int(counts.sum()) * 256
        if kind == "cloud":
            assert pairs == full
        else:
            assert 0 < pairs < full
        assert 0 < contributing < pairs
        # a pixel with no contributor keeps final_T = 1, and only there
        rows = B.blend2d_fwd_plain(a_t, r_t, W // 16, H // 16)
        assert contributing >= int((rows[..., B.O_T] < 1).sum())


def _cull_and_alpha(A, px, py):
    from gssr_tpu_torch.ops import blend2d as B
    return B.surfel_cull_plain(A, px, py), B._surfel_alpha(A, px, py).a


@pytest.mark.parametrize("kind", ["cloud", "overdraw"])
def test_cull_skips_only_zero_alpha_pairs(kind):
    """Every pair the cull skips has alpha 0, and the cull skips nearly all
    of the real instances' alpha-0 pairs (a cull that never fires, or only
    on fillers, fails)."""
    from gssr_tpu_torch.ops import blend2d as B
    from gssr_tpu_torch.ops.blend import _chunks, _pixel_coords
    attrs, b = _jax_fns(W, H)[0](*_scene(kind))
    a_t = torch.from_numpy(np.array(attrs))[:B.LIVE_ATTRS2]
    r_t = torch.from_numpy(np.array(b.tile_ranges))
    px, py = _pixel_coords(W // 16, H // 16, "cpu")
    culled = zero = 0
    for A, _, _ in _chunks(a_t, r_t):
        cull, a = _cull_and_alpha(A, px, py)
        assert not bool((cull & (a != 0)).any())
        real = (A[B.A_OP] > 0)[:, None, :]
        culled += int((cull & real).sum())
        zero += int(((a == 0) & real).sum())
    assert culled >= 0.9 * zero > 0, (culled, zero)


def _edge_chunk(rng, log_z, spread):
    """One tile's chunk [LIVE_ATTRS2, 1, CHUNK] of random surfels whose
    rho3d and rho2d at a pixel of the tile lie within `spread` (relative)
    of the alpha = 1/255 edge, 2 ln(255 op); their intersection p has scale
    10^log_z and varies over the tile."""
    from gssr_tpu_torch.ops import blend2d as B
    from gssr_tpu_torch.ops.blend import CHUNK
    n = CHUNK
    op = rng.uniform(1 / 255, 1.0, n)
    edge = 2 * np.log(255 * op)
    rho3 = edge * (1 + rng.uniform(-spread, spread, n))
    rho2 = edge * (1 + rng.uniform(-spread, spread, n))
    cx, cy = rng.integers(0, 16, (2, n))
    th, ph = rng.uniform(0, 2 * np.pi, (2, n))
    z = 10.0 ** log_z * rng.choice([-1.0, 1.0], n)
    p_c = np.stack([np.sqrt(rho3) * np.cos(th), np.sqrt(rho3) * np.sin(th),
                    np.ones(n)]) * z
    cb = rng.normal(0, 0.05, (3, n)) * z
    cc = rng.normal(0, 0.05, (3, n)) * z
    A = np.zeros((B.LIVE_ATTRS2, n))
    A[B.A_XY] = cx + np.sqrt(rho2 / 2) * np.cos(ph)
    A[B.A_XY + 1] = cy + np.sqrt(rho2 / 2) * np.sin(ph)
    A[B.A_CA:B.A_CA + 3] = p_c + cx * cb + cy * cc
    A[B.A_CB:B.A_CB + 3] = cb
    A[B.A_CC:B.A_CC + 3] = cc
    A[B.A_TW:B.A_TW + 2] = rng.normal(0, 0.1, (2, n))
    A[B.A_TW + 2] = rng.uniform(0.5, 3.0, n)
    A[B.A_OP] = op
    return torch.from_numpy(A.astype(np.float32))[:, None, :]


def _edge_draws():
    """(seed, log_z, spread): the corners of the ranges, then seeded
    draws inside them."""
    rng = np.random.default_rng(255)
    corners = [(k, z, s) for k, (z, s) in enumerate(
        (z, s) for z in (-3.0, 0.0, 3.0) for s in (0.0, 0.05))]
    draws = corners + [(int(rng.integers(2 ** 31)), float(rng.uniform(-3, 3)),
                        float(rng.uniform(0, 0.05))) for _ in range(10)]
    return [pytest.param(*d, id=f"z{d[1]:+.2f}-spread{d[2]:.3f}-{i}")
            for i, d in enumerate(draws)]


@pytest.mark.parametrize("seed,log_z,spread", _edge_draws())
def test_cull_is_conservative_at_the_alpha_edge(seed, log_z, spread):
    """Surfels whose alpha crosses 1/255 inside the tile: the cull skips no
    pair with alpha > 0, whatever the scale of the intersection."""
    from gssr_tpu_torch.ops.blend import _pixel_coords
    A = _edge_chunk(np.random.default_rng(seed), log_z, spread)
    cull, a = _cull_and_alpha(A, *_pixel_coords(1, 1, "cpu"))
    assert not bool((cull & (a != 0)).any())
    assert bool((a > 0).any()) and bool(cull.any())


def _one_surfel(op=0.5, p=(0.0, 0.0, 1.0), xy=(8.0, 8.0), depth=1.0):
    """One surfel with a constant intersection p over the tile, beside a
    filler column."""
    from gssr_tpu_torch.ops import blend2d as B
    A = torch.zeros(B.LIVE_ATTRS2, 1, 2)
    A[B.A_XY:B.A_XY + 2, 0, 0] = torch.tensor(xy)
    A[B.A_CA:B.A_CA + 3, 0, 0] = torch.tensor(p)
    A[B.A_TW + 2, 0, 0] = depth
    A[B.A_OP, 0, 0] = op
    return A


_EDGE = np.float32(1 / 255)
_CULL_CASES = {
    # alpha = op at the mean: just above 1/255 it blends, just below it
    # does not; neither may be culled wrongly
    "op_above": (_one_surfel(op=float(np.nextafter(_EDGE, 1))), True),
    "op_below": (_one_surfel(op=float(np.nextafter(_EDGE, 0)),
                             p=(0.5, 0.0, 1.0)), False),
    # pz = 0: no intersection, alpha 0 everywhere
    "pz_zero": (_one_surfel(p=(0.5, 0.5, 0.0)), False),
    # |p| > 1e4 |pz|: the clamp bounds s, rho3d >= 1e8; rho2d carries
    # alpha at the mean
    "clamped": (_one_surfel(p=(3e4, 0.0, 1.0)), True),
    "clamped_tiny_pz": (_one_surfel(p=(1.0, 1.0, 1e-30)), True),
    "clamped_far": (_one_surfel(p=(3e4, 0.0, 1.0), xy=(400.0, 8.0)), False),
}


@pytest.mark.parametrize("case", sorted(_CULL_CASES))
def test_cull_edge_cases(case):
    """The cull against the exact alpha on the cases where its algebra is
    thin: opacity at 1/255, pz = 0, the +-1e4 clamp and a filler column
    (the second column of every case). Where the surfel blends somewhere,
    the cull keeps those pixels; where it blends nowhere, it and the
    filler are culled at every pixel."""
    from gssr_tpu_torch.ops.blend import _pixel_coords
    A, blends = _CULL_CASES[case]
    px, py = _pixel_coords(1, 1, "cpu")
    cull, a = _cull_and_alpha(A, px, py)
    assert not bool((cull & (a != 0)).any())
    assert bool(cull[..., 1].all())                       # the filler
    assert bool((a[..., 0] > 0).any()) == blends
    if not blends:
        assert bool(cull[..., 0].all())


def test_cull_shares_count_the_walked_pairs():
    """chip_smoke.py's surfel_cull_counts, on which the surfel kernels'
    bounds rest: its pairs are blend2d_pair_count's, it culls most of them
    on the cloud scene, and a warp step is skipped whole at most as often
    as it is walked."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import surfel_cull_counts
    from gssr_tpu_torch.ops import blend2d as B
    attrs, b = _jax_fns(W, H)[0](*_scene("cloud"))
    a_t = torch.from_numpy(np.array(attrs))
    r_t = torch.from_numpy(np.array(b.tile_ranges))
    c = surfel_cull_counts(a_t, r_t, W // 16, H // 16)
    pairs, _ = B.blend2d_pair_count(a_t, r_t, W // 16, H // 16)
    assert c.pairs == pairs
    assert 0.5 * pairs < c.culled < pairs
    assert 0 < c.whole < c.steps <= pairs // 32
    assert c.in_whole + c.proof == c.culled


@pytest.mark.cuda
def test_blend2d_kernels_match_plain_on_the_card():
    """CUDA kernels against their plain versions on the same inputs; each
    kernel and its first design (blend2d_fwd_v1, blend2d_bwd_v1) also
    against each other: the forwards bit for bit on all 16 channels, the
    backwards each twice, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at full size")
    from gssr_tpu_torch.ops import blend2d as B
    tx, ty = W // 16, H // 16
    attrs, b = _jax_fns(W, H)[0](*_scene("overdraw"))
    dev = torch.device("cuda")
    a = torch.as_tensor(np.array(attrs), device=dev)
    r = torch.as_tensor(np.array(b.tile_ranges), device=dev)
    out_k = B.blend2d_fwd(a, r, tx, ty)
    out_p = B.blend2d_fwd_plain(a, r, tx, ty)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=1e-4)
    assert torch.equal(out_k[..., B.O_SELPOS], out_p[..., B.O_SELPOS])
    assert torch.equal(out_k, B.blend2d_fwd_v1(a, r, tx, ty))
    cot = torch.randn(out_k.shape, device=dev)
    d_p = B.blend2d_bwd_plain(a, r, out_k, cot, tx, ty)
    d_k = {}
    for bwd in (B.blend2d_bwd, B.blend2d_bwd_v1):
        d_k[bwd] = bwd(a, r, out_k, cot, tx, ty)
        torch.testing.assert_close(d_k[bwd], d_p, atol=2e-4, rtol=2e-3)
        assert torch.equal(d_k[bwd], bwd(a, r, out_k, cot, tx, ty))
    torch.testing.assert_close(d_k[B.blend2d_bwd], d_k[B.blend2d_bwd_v1],
                               atol=2e-4, rtol=2e-3)
