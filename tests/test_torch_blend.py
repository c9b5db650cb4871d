"""The port's tile blend against gssr_tpu's Pallas blend (interpret mode).

`blend` runs the instance pack and `TileBlend`, which on the CPU takes
the kernels' plain versions blend_fwd_plain / blend_bwd_plain. Inputs are
the shapes of tests/test_blend_pallas.py. Tolerances are that file's:
forward atol 1e-5 / rtol 1e-4, gradients atol 2e-4 / rtol 2e-3.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _camera_kwargs(w, h):
    return dict(uid=0, colmap_id=0, image_name="t", R=np.eye(3),
                T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(60),
                fovy=math.radians(60), width=w, height=h)


def _scene(kind, rng):
    if kind == "overdraw":
        # many nearly-opaque gaussians stacked at one spot: T collapses
        # and the early stop fires
        n = 48
        means = rng.normal(0, 0.02, (n, 3))
        means[:, 2] = np.linspace(-1, 1, n)
        scales = np.full((n, 3), 0.25)
        rots = np.tile([1.0, 0, 0, 0], (n, 1))
        opac = np.full(n, 0.95)
    else:
        n = int(kind)
        means = rng.uniform(-1.5, 1.5, (n, 3))
        scales = rng.uniform(0.02, 0.3, (n, 3))
        rots = rng.normal(size=(n, 4))
        opac = rng.uniform(0.1, 1.0, n)
    colors = rng.uniform(0, 1, (n, 3))
    f32 = lambda x: np.asarray(x, np.float32)
    return tuple(map(f32, (means, scales, rots, opac, colors)))


@functools.lru_cache(maxsize=None)
def _jax_fns(w, h):
    """jitted gssr_tpu preprocess + binning, and the Pallas blend's value
    and gradient, for one image size."""
    from gssr_tpu.cameras import Camera
    from gssr_tpu.ops.binning import bin_gaussians
    from gssr_tpu.ops.blend_pallas import blend_pallas
    from gssr_tpu.ops.projection import preprocess
    cam = Camera(**_camera_kwargs(w, h)).arrays()

    @jax.jit
    def prep(means, scales, rots, opac):
        proj = preprocess(means, scales, rots, cam, w, h, opacity=opac)
        binning = bin_gaussians(proj.rect, proj.depth, proj.tiles_touched,
                                w // 16, h // 16, 2048, chunk=128,
                                tile_mask=proj.tile_mask)
        return proj, binning

    def loss(mean2d, conic, color, opacity, binning, bg, cot, cot_T):
        img, T = blend_pallas(mean2d, conic, color, opacity, binning, w, h,
                              bg)
        return jnp.sum(img * cot) + jnp.sum(T * cot_T), (img, T)

    return prep, jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                            has_aux=True))


def _blend_inputs(scene, w, h):
    """Screen-space inputs of the blend from gssr_tpu's own preprocess,
    and its binning."""
    means, scales, rots, opac, colors = scene
    proj, binning = _jax_fns(w, h)[0](means, scales, rots, opac)
    return dict(mean2d=proj.mean2d, conic=proj.conic, color=colors,
                opacity=opac, rect=proj.rect, depth=proj.depth,
                tiles=proj.tiles_touched, mask=proj.tile_mask), binning


@pytest.mark.parametrize("kind,w,h", [("1", 32, 16), ("48", 32, 16),
                                      ("24", 16, 16), ("overdraw", 16, 16)])
def test_blend_matches_pallas(kind, w, h):
    from gssr_tpu_torch.ops.binning import bin_gaussians as tbin
    from gssr_tpu_torch.ops.blend import blend
    rng = np.random.default_rng(0)
    inp, jb = _blend_inputs(_scene(kind, rng), w, h)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cot = rng.normal(size=(h, w, 3)).astype(np.float32)
    cot_T = rng.normal(size=(h, w)).astype(np.float32)
    diff = ("mean2d", "conic", "color", "opacity")
    (_, (img_j, T_j)), g_j = _jax_fns(w, h)[1](
        *(inp[k] for k in diff), jb, bg, cot, cot_T)

    tb = tbin(*(torch.from_numpy(np.asarray(inp[k]))
                for k in ("rect", "depth", "tiles")), w // 16, h // 16,
              torch.from_numpy(np.asarray(inp["mask"])))
    ts = [torch.tensor(np.asarray(inp[k]), requires_grad=True) for k in diff]
    img_t, T_t = blend(*ts, tb, w, h, torch.from_numpy(bg))
    loss = (img_t * torch.from_numpy(cot)).sum() \
        + (T_t * torch.from_numpy(cot_T)).sum()
    g_t = torch.autograd.grad(loss, ts)

    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(T_t.detach().numpy(), np.asarray(T_j),
                               atol=1e-5, rtol=1e-4)
    if kind == "overdraw":
        assert float(T_t.detach().min()) < 1e-3          # saturated pixels exist
    for name, a, b in zip(diff, g_j, g_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-4,
                                   rtol=2e-3, err_msg=name)


def test_segment_sum_is_the_per_gaussian_sum():
    """The gather's backward equals an index_add in float64, and is
    bitwise reproducible."""
    from gssr_tpu_torch.ops.blend import segment_sum_sorted
    rng = np.random.default_rng(3)
    n, slots = 50, 1024
    counts = rng.integers(0, 12, n)
    counts[[3, 17]] = 0                               # empty segments
    gid = np.repeat(np.arange(n), counts)
    real = len(gid)
    gid_reduce = np.concatenate([gid, np.full(slots - real, n)])
    rng.shuffle(gid_reduce)
    vals = rng.normal(size=(slots, 9)).astype(np.float32)
    vals[gid_reduce == n] = 0.0
    seg_bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    args = (torch.from_numpy(vals), torch.from_numpy(gid_reduce.astype(
        np.int32)), torch.from_numpy(seg_bounds))
    out = segment_sum_sorted(*args)
    ref = torch.zeros(n + 1, 9, dtype=torch.float64).index_add_(
        0, torch.from_numpy(gid_reduce), torch.from_numpy(vals).double())[:n]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)
    assert torch.equal(out, segment_sum_sorted(*args))


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """CUDA kernels against their plain versions on the same inputs, the
    forward also on the alpha-edge draws (one tile each); the backward
    also against a second run of itself, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at full size")
    from gssr_tpu_torch.ops import blend as B
    from gssr_tpu_torch.ops.binning import bin_gaussians
    rng = np.random.default_rng(1)
    w, h = 64, 48
    inp, _ = _blend_inputs(_scene("300", rng), w, h)
    dev = torch.device("cuda")
    tb = bin_gaussians(*(torch.as_tensor(np.asarray(inp[k]), device=dev)
                         for k in ("rect", "depth", "tiles")), w // 16,
                       h // 16, torch.as_tensor(np.asarray(inp["mask"]),
                                                device=dev))
    attrs = B.pack_instance_attrs(
        *(torch.as_tensor(np.asarray(inp[k]), device=dev)
          for k in ("mean2d", "conic", "color", "opacity")), tb)
    out_k = B.blend_fwd(attrs, tb.tile_ranges, w // 16, h // 16)
    out_p = B.blend_fwd_plain(attrs, tb.tile_ranges, w // 16, h // 16)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=1e-4)
    cot = torch.randn(out_k.shape, device=dev)
    d_k = B.blend_bwd(attrs, tb.tile_ranges, out_k, cot, w // 16, h // 16)
    d_p = B.blend_bwd_plain(attrs, tb.tile_ranges, out_k, cot, w // 16,
                            h // 16)
    torch.testing.assert_close(d_k, d_p, atol=2e-4, rtol=2e-3)
    assert torch.equal(d_k, B.blend_bwd(attrs, tb.tile_ranges, out_k, cot,
                                        w // 16, h // 16))
    a, r, tx, ty = (x.to(dev) if torch.is_tensor(x) else x
                    for x in edge_tiles(B.LIVE_ATTRS, B.NUM_ATTRS))
    torch.testing.assert_close(B.blend_fwd(a, r, tx, ty),
                               B.blend_fwd_plain(a, r, tx, ty), atol=1e-5,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# The forward kernels' alpha cull (csrc/common.cuh), through its plain
# versions: neither the per-pair nor the per-(warp, instance) test may skip a
# pair whose exact alpha (_chunk_alpha) is nonzero. The planar layout shares
# rows 0-5 and the cull; tests/test_torch_blend_pgsr.py runs these helpers
# on it.
# ---------------------------------------------------------------------------

def cull_masks(A, px, py):
    """(exact alpha [T, PIX, C], pairs the per-pair proof culls, [T, WARPS,
    C] steps the warp test culls) of chunk A; asserts that neither culls a
    pair, or a warp a block, where the exact alpha is nonzero."""
    from gssr_tpu_torch.ops import blend as B
    a, _ = B._chunk_alpha(A, px, py)
    pair = B.alpha_cull_plain(A, px, py)
    warp = B.warp_cull_plain(A, px, py)
    assert not bool((pair & (a != 0)).any())
    assert not bool((warp & B.warp_blocks(a != 0).any(2)).any())
    return a, pair, warp


def assert_cull_is_conservative(attrs, ranges, tiles_x, tiles_y):
    """Over every chunk of a scene: no wrong skip, and both culls fire on
    most alpha-0 pairs of its real instances (a cull that never fires, or
    only on fillers, fails)."""
    from gssr_tpu_torch.ops import blend as B
    px, py = B._pixel_coords(tiles_x, tiles_y, "cpu")
    culled = zero = warps = 0
    for A, _, _ in B._chunks(attrs, ranges):
        real = (A[B.ATTR_OP] > 0)[:, None, :]
        a, pair, warp = cull_masks(A, px, py)
        culled += int((pair & real).sum())
        zero += int(((a == 0) & real).sum())
        warps += int((warp & real).sum())
    assert culled >= 0.9 * zero > 0, (culled, zero)
    assert warps > 0


@pytest.mark.parametrize("kind,w,h", [("48", 32, 16), ("300", 64, 48),
                                      ("overdraw", 16, 16)])
def test_cull_skips_only_zero_alpha_pairs(kind, w, h):
    from gssr_tpu_torch.ops.binning import bin_gaussians as tbin
    from gssr_tpu_torch.ops.blend import pack_instance_attrs
    inp, _ = _blend_inputs(_scene(kind, np.random.default_rng(0)), w, h)
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    tb = tbin(t["rect"], t["depth"], t["tiles"], w // 16, h // 16, t["mask"])
    attrs = pack_instance_attrs(t["mean2d"], t["conic"], t["color"],
                                t["opacity"], tb)
    assert_cull_is_conservative(attrs, tb.tile_ranges, w // 16, h // 16)


def test_gauss_cull_counts_charge_the_warp_test():
    """chip_smoke.py's gauss_cull_counts and gauss_pair_ops, on which the
    vanilla and planar kernels' bounds rest: the pairs are
    blend_pair_count's, the warp test skips steps whole, every pair inside
    them is one the per-pair proof covers too, and a skipped step is
    charged the warp test once, fewer operations than the per-pair proof
    on its pairs."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import (
        GAUSS_OPS_PER_BLOCK_TEST,
        GAUSS_OPS_PER_CULLED,
        gauss_cull_counts,
        gauss_pair_ops,
    )
    from gssr_tpu_torch.ops.binning import bin_gaussians as tbin
    from gssr_tpu_torch.ops.blend import blend_pair_count, pack_instance_attrs
    w, h = 64, 48
    inp, _ = _blend_inputs(_scene("300", np.random.default_rng(0)), w, h)
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    tb = tbin(t["rect"], t["depth"], t["tiles"], w // 16, h // 16, t["mask"])
    attrs = pack_instance_attrs(t["mean2d"], t["conic"], t["color"],
                                t["opacity"], tb)
    c = gauss_cull_counts(attrs, tb.tile_ranges, w // 16, h // 16)
    pairs, _ = blend_pair_count(attrs, tb.tile_ranges, w // 16, h // 16)
    assert c.pairs == pairs
    assert 0 < c.whole < c.steps and pairs <= 32 * c.steps
    assert c.whole < c.in_whole <= 32 * c.whole
    assert c.in_whole + c.proof == c.culled < pairs
    assert GAUSS_OPS_PER_BLOCK_TEST * c.whole \
        < GAUSS_OPS_PER_CULLED * c.in_whole
    full = 28 * pairs
    assert gauss_pair_ops(28, c) == full - 28 * (c.in_whole + c.proof) \
        + GAUSS_OPS_PER_CULLED * c.proof + GAUSS_OPS_PER_BLOCK_TEST * c.whole


def edge_chunk(rng, log_c, spread, rows):
    """One tile's chunk [rows, 1, CHUNK] of random gaussians whose power at
    a corner pixel of one of the tile's 8 x 4 blocks lies within `spread`
    (relative) of the alpha = 1/255 edge -ln(255 op), their means outside
    the block beyond that corner; conic scale 10^log_c, some nearly
    degenerate."""
    from gssr_tpu_torch.ops import blend as B
    n = B.CHUNK
    op = rng.uniform(1 / 255, 1.0, n)
    edge = np.log(255 * op)                       # -power at the edge
    q = edge * (1 + rng.uniform(-spread, spread, n))
    s = 10.0 ** log_c * np.exp(rng.uniform(-1, 1, (2, n)))
    rho = rng.uniform(-0.999, 0.999, n)
    cxx, cyy = s
    cxy = rho * np.sqrt(cxx * cyy)
    w = rng.integers(0, B.WARPS, n)
    cx = (w % 2) * 8 + rng.choice([0, 7], n)
    cy = (w // 2) * 4 + rng.choice([0, 3], n)
    # a direction away from the block at that corner, scaled so that
    # Q(corner - mean) = q
    vx = np.where(cx % 8 == 0, -1.0, 1.0) * rng.uniform(0, 1, n)
    vy = np.where(cy % 4 == 0, -1.0, 1.0) * rng.uniform(0, 1, n)
    qv = 0.5 * (cxx * vx * vx + cyy * vy * vy) + cxy * vx * vy
    k = np.sqrt(q / qv)
    A = np.zeros((rows, n))
    A[B.ATTR_MX] = cx + k * vx
    A[B.ATTR_MY] = cy + k * vy
    A[B.ATTR_CXX], A[B.ATTR_CXY], A[B.ATTR_CYY] = cxx, cxy, cyy
    A[B.ATTR_OP] = op
    A[B.ATTR_OP + 1:] = rng.uniform(0, 1, (rows - B.ATTR_OP - 1, n))
    return torch.from_numpy(A.astype(np.float32))[:, None, :]


def edge_draws():
    """(seed, log_c, spread): the corners of the ranges, then seeded draws
    inside them."""
    rng = np.random.default_rng(255)
    corners = [(k, c, s) for k, (c, s) in enumerate(
        (c, s) for c in (-3.0, -1.0, 1.0) for s in (0.0, 0.05))]
    draws = corners + [(int(rng.integers(2 ** 31)), float(rng.uniform(-3, 1)),
                        float(rng.uniform(0, 0.05))) for _ in range(10)]
    return [pytest.param(*d, id=f"c{d[1]:+.2f}-spread{d[2]:.3f}-{i}")
            for i, d in enumerate(draws)]


def check_edge_chunk(A):
    """Gaussians at the alpha edge: no wrong skip, and both outcomes
    occur, blending pairs and culled ones."""
    from gssr_tpu_torch.ops.blend import _pixel_coords
    a, pair, warp = cull_masks(A, *_pixel_coords(1, 1, "cpu"))
    assert bool((a > 0).any()) and bool(pair.any()) and bool(warp.any())


def edge_tiles(live, rows):
    """Every edge draw as one tile of a 16-tile strip: (attrs [rows, I]
    with rows `live` on zero, ranges, tiles_x, tiles_y), for the kernels'
    comparison with their plain versions on the card."""
    from gssr_tpu_torch.ops import blend as B
    chunks = []
    for t, d in enumerate(edge_draws()):
        seed, log_c, spread = d.values
        A = edge_chunk(np.random.default_rng(seed), log_c, spread, live)[:, 0]
        A[B.ATTR_MX] += 16 * t
        chunks.append(torch.cat([A, A.new_zeros(rows - live, B.CHUNK)]))
    n = len(chunks)
    ranges = torch.arange(n + 1, dtype=torch.int32) * B.CHUNK
    return torch.cat(chunks, 1).contiguous(), ranges, n, 1


@pytest.mark.parametrize("seed,log_c,spread", edge_draws())
def test_cull_is_conservative_at_the_alpha_edge(seed, log_c, spread):
    from gssr_tpu_torch.ops.blend import LIVE_ATTRS
    check_edge_chunk(edge_chunk(np.random.default_rng(seed), log_c, spread,
                                LIVE_ATTRS))


_F_EDGE = np.float32(1 / 255)
# (op, conic, mean, whether it blends somewhere, whether a warp may cull it)
CULL_CASES = {
    "filler": (0.0, (0.0, 0.0, 0.0), (0.0, 0.0), False, True),
    "op_above": (float(np.nextafter(_F_EDGE, 1)), (0.5, 0.1, 0.5),
                 (8.0, 8.0), True, True),
    "op_below": (float(np.nextafter(_F_EDGE, 0)), (0.5, 0.1, 0.5),
                 (8.0, 8.0), False, True),
    "op_nan": (float("nan"), (0.5, 0.1, 0.5), (8.0, 8.0), False, False),
    "huge_conic": (0.9, (1e6, 0.0, 1e6), (8.0, 8.0), True, True),
    "conic_out_of_range": (0.9, (1e13, 0.0, 1e13), (8.0, 8.0), True, False),
    "degenerate": (0.9, (1.0, 1.0, 1.0), (3.5, 9.5), True, False),
    "mean_at_centre": (0.5, (0.02, -0.01, 0.03), (5.0, 6.0), True, True),
    "power_positive": (0.9, (-1.0, 0.0, -1.0), (8.0, 8.0), True, False),
}


def cull_case(case, rows):
    """Column 0 the case, column 1 a filler: chunk [rows, 1, 2]."""
    from gssr_tpu_torch.ops import blend as B
    op, (cxx, cxy, cyy), (mx, my), _, _ = CULL_CASES[case]
    A = torch.zeros(rows, 1, 2)
    for r, v in ((B.ATTR_MX, mx), (B.ATTR_MY, my), (B.ATTR_CXX, cxx),
                 (B.ATTR_CXY, cxy), (B.ATTR_CYY, cyy), (B.ATTR_OP, op)):
        A[r, 0, 0] = v
    return A


def check_cull_case(case, A):
    """The cull against the exact alpha where its algebra is thin; the
    filler column is culled at every pixel and by every warp."""
    from gssr_tpu_torch.ops import blend as B
    _, _, _, blends, warp_may = CULL_CASES[case]
    a, pair, warp = cull_masks(A, *B._pixel_coords(1, 1, "cpu"))
    assert bool(pair[..., 1].all()) and bool(warp[..., 1].all())
    assert bool((a[..., 0] > 0).any()) == blends
    if not warp_may:
        assert not bool(warp[..., 0].any())
    if case == "filler":
        assert bool(pair.all()) and bool(warp.all())
    if case == "op_nan":
        assert not bool(pair[..., 0].any())
    if case == "huge_conic":
        # alpha > 0 at the mean's pixel alone; every other warp culls it
        assert int((a[..., 0] > 0).sum()) == 1
        assert int(warp[..., 0].sum()) == B.WARPS - 1


@pytest.mark.parametrize("case", sorted(CULL_CASES))
def test_cull_edge_cases(case):
    from gssr_tpu_torch.ops.blend import LIVE_ATTRS
    check_cull_case(case, cull_case(case, LIVE_ATTRS))
