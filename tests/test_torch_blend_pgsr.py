"""The port's planar (PGSR) blend against gssr_tpu's Pallas planar kernels
(interpret mode), on the same attribute pack, tile ranges and cotangent.

blend_pgsr_fwd / blend_pgsr_observe / blend_pgsr_bwd take their plain
versions on the CPU. The inputs come from gssr_tpu's own preprocess,
binning and pack, with random camera-space normals and plane distances,
and in one case an overdraw stack of nearly-opaque gaussians so that a
tile saturates. Tolerances: forward atol 1e-5 / rtol 1e-4, gradient rows
0-12 and 14-15 atol 2e-4 / rtol 2e-3 (tests/test_blend_pallas.py), the
observe counts (the observe kernel and backward row 13) exactly.

The planar forward kernel's alpha cull is the vanilla forward's
(csrc/common.cuh, on rows 0-5): its plain versions never skip a pair with
nonzero alpha on the planar packs, at the alpha edge and in the edge cases
of tests/test_torch_blend.py, whose helpers run here on the planar layout.
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

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_blend import (  # noqa: E402
    CULL_CASES,
    assert_cull_is_conservative,
    check_cull_case,
    check_edge_chunk,
    cull_case,
    edge_chunk,
    edge_draws,
    edge_tiles,
)

W, H = 32, 16


def _camera_kwargs(w, h):
    return dict(uid=0, colmap_id=0, image_name="t", R=np.eye(3),
                T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(60),
                fovy=math.radians(60), width=w, height=h)


def _scene(kind, seed=0):
    """numpy gaussians (means, scales, rots, opacity, colors, camera-space
    normals, plane distances)."""
    rng = np.random.default_rng(seed)
    n = 48
    means = rng.uniform(-1.5, 1.5, (n, 3))
    scales = rng.uniform(0.02, 0.3, (n, 3))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.1, 1.0, n)
    if kind == "overdraw":
        # nearly-opaque gaussians stacked in front of one spot: T collapses
        # there and the tile's walk stops early
        k = 32
        means[:k] = np.stack([rng.normal(-0.5, 0.02, k),
                              rng.normal(-0.3, 0.02, k),
                              np.linspace(-1.0, 1.0, k)], 1)
        scales[:k] = 0.25
        opac[:k] = 0.95
    colors = rng.uniform(0, 1, (n, 3))
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    dist = rng.uniform(0.5, 5.0, n)
    f32 = lambda x: np.asarray(x, np.float32)               # noqa: E731
    return tuple(map(f32, (means, scales, rots, opac, colors, normals,
                           dist)))


@functools.lru_cache(maxsize=None)
def _jax_fns(w, h):
    from gssr_tpu.cameras import Camera
    from gssr_tpu.ops.binning import bin_gaussians
    from gssr_tpu.ops.blend_pgsr_pallas import (
        _run_bwdp,
        _run_fwdp,
        _run_obsp,
        pack_instance_attrs_pgsr,
    )
    from gssr_tpu.ops.projection import preprocess
    cam = Camera(**_camera_kwargs(w, h)).arrays()

    @jax.jit
    def pack(means, scales, rots, opac, colors, normals, dist):
        proj = preprocess(means, scales, rots, cam, w, h, opacity=opac)
        b = bin_gaussians(proj.rect, proj.depth, proj.tiles_touched,
                          w // 16, h // 16, 4096, chunk=128,
                          tile_mask=proj.tile_mask)
        n = means.shape[0]
        attrs = pack_instance_attrs_pgsr(
            proj.mean2d, proj.conic, colors, opac, normals, dist,
            jnp.zeros((n, 1)), jnp.zeros((n, 2)), b)
        return attrs, b

    t = dict(tiles_x=w // 16, tiles_y=h // 16)
    return (pack, jax.jit(functools.partial(_run_fwdp, **t)),
            jax.jit(functools.partial(_run_obsp, **t)),
            jax.jit(functools.partial(_run_bwdp, **t)))


@pytest.mark.parametrize("kind", ["cloud", "overdraw"])
def test_plain_planar_blend_matches_pallas(kind):
    from gssr_tpu.ops.blend_pgsr_pallas import _rows_to_tiles, _tiles_to_rows
    from gssr_tpu_torch.ops import blend_pgsr as B
    tx, ty = W // 16, H // 16
    pack, fwd, obs, bwd = _jax_fns(W, H)
    attrs, b = pack(*_scene(kind))
    out_j = fwd(attrs, b.tile_ranges)
    rows_j = np.asarray(_tiles_to_rows(out_j, tx, ty))
    obs_j = np.asarray(obs(attrs, b.chunk_map, b.n_live_chunks))[0]
    cot = np.random.default_rng(5).normal(size=rows_j.shape).astype(
        np.float32)
    d_j = np.asarray(bwd(attrs, b.chunk_map, b.n_live_chunks, out_j,
                         _rows_to_tiles(jnp.asarray(cot), tx, ty)))

    a_t = torch.from_numpy(np.array(attrs))
    r_t = torch.from_numpy(np.array(b.tile_ranges))
    rows_t = B.blend_pgsr_fwd(a_t, r_t, tx, ty)
    np.testing.assert_allclose(rows_t.numpy(), rows_j, atol=1e-5, rtol=1e-4)
    if kind == "overdraw":
        assert rows_j[..., B.PO_T].min() < 1e-3          # a tile saturates

    obs_t = B.blend_pgsr_observe(a_t, r_t, tx, ty)
    np.testing.assert_array_equal(obs_t.numpy(), obs_j)
    assert obs_j.sum() > 0

    d_t = B.blend_pgsr_bwd(a_t, r_t, rows_t, torch.from_numpy(cot), tx,
                           ty).numpy()
    live = B.LIVE_ATTRS_P
    assert np.abs(d_j[:live]).max(axis=1).min() > 0      # every row is live
    grad_rows = [r for r in range(B.NUM_ATTRS_P) if r != B.P_OBS]
    np.testing.assert_allclose(d_t[grad_rows], d_j[grad_rows], atol=2e-4,
                               rtol=2e-3)
    # the backward's side channel counts exactly what the observe kernel
    # counts, whatever the cotangent
    np.testing.assert_array_equal(d_t[B.P_OBS], d_j[B.P_OBS])
    np.testing.assert_array_equal(d_t[B.P_OBS], obs_t.numpy())
    assert (d_t[B.P_ABSX] >= np.abs(d_t[0]) - 1e-6).all()


def test_pgsr_pair_count_counts_the_walked_pairs():
    """ops/blend.py's pair count on the planar layout (it reads rows 0-5,
    which the layouts share): every pixel of an unsaturated tile walks all
    instances of its tile; the contributing pairs are the (pixel,
    instance) pairs with a blend weight, so each observe count is at most
    its instance's share."""
    from gssr_tpu_torch.ops import blend_pgsr as B
    from gssr_tpu_torch.ops.blend import blend_pair_count
    pack = _jax_fns(W, H)[0]
    for kind in ("cloud", "overdraw"):
        attrs, b = pack(*_scene(kind))
        a_t = torch.from_numpy(np.array(attrs))
        r_t = torch.from_numpy(np.array(b.tile_ranges))
        counts = np.diff(np.asarray(b.tile_ranges))
        pairs, contributing = blend_pair_count(a_t, r_t, W // 16, H // 16)
        full = int(counts.sum()) * 256
        if kind == "cloud":
            assert pairs == full
        else:
            assert 0 < pairs < full
        obs = B.blend_pgsr_obs_plain(a_t, r_t, W // 16, H // 16)
        assert 0 < float(obs.sum()) <= contributing < pairs


@pytest.mark.parametrize("kind", ["cloud", "overdraw"])
def test_planar_cull_skips_only_zero_alpha_pairs(kind):
    from gssr_tpu_torch.ops import blend_pgsr as B
    attrs, b = _jax_fns(W, H)[0](*_scene(kind))
    assert_cull_is_conservative(
        torch.from_numpy(np.array(attrs))[:B.LIVE_ATTRS_P],
        torch.from_numpy(np.array(b.tile_ranges)), W // 16, H // 16)


@pytest.mark.parametrize("seed,log_c,spread", edge_draws())
def test_planar_cull_is_conservative_at_the_alpha_edge(seed, log_c, spread):
    from gssr_tpu_torch.ops.blend_pgsr import LIVE_ATTRS_P
    check_edge_chunk(edge_chunk(np.random.default_rng(seed), log_c, spread,
                                LIVE_ATTRS_P))


@pytest.mark.parametrize("case", sorted(CULL_CASES))
def test_planar_cull_edge_cases(case):
    from gssr_tpu_torch.ops.blend_pgsr import LIVE_ATTRS_P
    check_cull_case(case, cull_case(case, LIVE_ATTRS_P))


@pytest.mark.cuda
def test_planar_kernels_match_plain_on_the_card():
    """The three CUDA kernels against their plain versions on the same
    inputs, the forward also on the alpha-edge draws (one tile each); the
    backward and its first design (blend_pgsr_bwd_v1) also
    against each other and each twice, bit for bit, with the observe
    kernel's counts in row 13."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "at full size")
    from gssr_tpu_torch.ops import blend_pgsr as B
    tx, ty = W // 16, H // 16
    attrs, b = _jax_fns(W, H)[0](*_scene("overdraw"))
    dev = torch.device("cuda")
    a = torch.as_tensor(np.array(attrs), device=dev)
    r = torch.as_tensor(np.array(b.tile_ranges), device=dev)
    out_k = B.blend_pgsr_fwd(a, r, tx, ty)
    out_p = B.blend_pgsr_fwd_plain(a, r, tx, ty)
    torch.testing.assert_close(out_k, out_p, atol=1e-5, rtol=1e-4)
    obs_k = B.blend_pgsr_observe(a, r, tx, ty)
    assert torch.equal(obs_k, B.blend_pgsr_obs_plain(a, r, tx, ty))
    cot = torch.randn(out_k.shape, device=dev)
    d_p = B.blend_pgsr_bwd_plain(a, r, out_k, cot, tx, ty)
    d_k = {}
    for bwd in (B.blend_pgsr_bwd, B.blend_pgsr_bwd_v1):
        d_k[bwd] = bwd(a, r, out_k, cot, tx, ty)
        torch.testing.assert_close(d_k[bwd], d_p, atol=2e-4, rtol=2e-3)
        assert torch.equal(d_k[bwd][B.P_OBS], obs_k)
        assert torch.equal(d_k[bwd], bwd(a, r, out_k, cot, tx, ty))
    torch.testing.assert_close(d_k[B.blend_pgsr_bwd],
                               d_k[B.blend_pgsr_bwd_v1], atol=2e-4,
                               rtol=2e-3)
    a, r, tx, ty = (x.to(dev) if torch.is_tensor(x) else x
                    for x in edge_tiles(B.LIVE_ATTRS_P, B.NUM_ATTRS_P))
    torch.testing.assert_close(B.blend_pgsr_fwd(a, r, tx, ty),
                               B.blend_pgsr_fwd_plain(a, r, tx, ty),
                               atol=1e-5, rtol=1e-4)
