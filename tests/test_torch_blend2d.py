"""The port's surfel blend against gssr_tpu's Pallas surfel kernels
(interpret mode), on the same attribute pack and tile ranges.

blend2d_fwd / blend2d_bwd take their plain versions on the CPU. The
inputs come from gssr_tpu's own preprocess_2d, binning and pack, with an
overdraw stack of nearly-opaque disks so that a tile saturates and pixels
have a median. Tolerances: forward atol 1e-5 / rtol 1e-4, gradients
atol 2e-4 / rtol 2e-3 (tests/test_blend_pallas.py), the median's sorted
position exactly.
"""
import functools
import math

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


@pytest.mark.cuda
def test_blend2d_kernels_match_plain_on_the_card():
    """CUDA kernels against their plain versions on the same inputs."""
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
    cot = torch.randn(out_k.shape, device=dev)
    d_k = B.blend2d_bwd(a, r, out_k, cot, tx, ty)
    d_p = B.blend2d_bwd_plain(a, r, out_k, cot, tx, ty)
    torch.testing.assert_close(d_k, d_p, atol=2e-4, rtol=2e-3)
    assert torch.equal(d_k, B.blend2d_bwd(a, r, out_k, cot, tx, ty))
