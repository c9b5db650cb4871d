"""ops/band.py against gssr_tpu/ops/band.py on one process: the band clip
of tile rects, intersect masks and exact counts bit for bit, the band-local
screen positions, and the surfel map's rebase to band rows
(gssr_tpu/ops/rasterize2d.py's expression)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gssr_tpu_torch.ops import band as tb


def _rects(rng, n=4000, tiles_y=12):
    """Random tile rects over a 100 x tiles_y grid: some wider than the
    32-tile mask window, some of no area, a fifth culled (tiles 0), and
    random 32-bit masks."""
    x0 = rng.integers(0, 60, n)
    w = rng.integers(0, 40, n)
    y0 = rng.integers(0, tiles_y, n)
    h = rng.integers(0, tiles_y, n)
    rect = np.stack([x0, y0, x0 + w, np.minimum(y0 + h, tiles_y)], 1)
    tiles = (w * (rect[:, 3] - y0)) * (rng.uniform(size=n) > 0.2)
    mask = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    return rect.astype(np.int32), tiles.astype(np.int32), \
        mask.astype(np.int32)


@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("with_mask", [True, False])
def test_clip_to_band_equals_gssr_tpu_bit_for_bit(bands, with_mask):
    from gssr_tpu.ops import band as jb
    rect, tiles, mask = _rects(np.random.default_rng(bands))
    band_ty = 12 // bands
    for r in range(bands):
        ty0 = r * band_ty
        want = jb.clip_to_band(jnp.asarray(rect), jnp.asarray(tiles),
                               jnp.asarray(mask) if with_mask else None,
                               jnp.int32(ty0), band_ty)
        got = tb.clip_to_band(torch.from_numpy(rect),
                              torch.from_numpy(tiles),
                              torch.from_numpy(mask) if with_mask else None,
                              tb.band_ty0(r, band_ty), band_ty)
        for name, a, b in zip(("rect", "tiles", "mask", "exact"), want, got):
            if a is None:
                assert b is None
                continue
            a = np.asarray(a)
            assert b.dtype == torch.int32, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
        # the bands partition each live rect's area
        assert int(got[1].sum()) <= int(tiles.sum())
    assert sum(int(tb.clip_to_band(torch.from_numpy(rect),
                                   torch.from_numpy(tiles), None,
                                   r * band_ty, band_ty)[1].sum())
               for r in range(bands)) == int(tiles.sum())


def test_shift_mean2d_equals_gssr_tpu():
    from gssr_tpu.ops import band as jb
    m = np.random.default_rng(0).uniform(-50, 400, (500, 2)).astype(
        np.float32)
    for ty0 in (0, 3, 11):
        np.testing.assert_array_equal(
            tb.shift_mean2d(torch.from_numpy(m), ty0).numpy(),
            np.asarray(jb.shift_mean2d(jnp.asarray(m), jnp.int32(ty0))))


@pytest.mark.parametrize("ty0", [0, 2, 33])
def test_tmat_rebase_equals_gssr_tpu_rasterize2d(ty0):
    """gssr_tpu/ops/rasterize2d.py's band rebase of the homogeneous map:
    Tv_local = Tv - (ty0 * TILE) * Tw, bit for bit, and its gradient."""
    T = np.random.default_rng(ty0).normal(size=(300, 3, 3)).astype(
        np.float32) * 50
    dy = (jnp.int32(ty0) * 16).astype(jnp.float32)
    jT = jnp.asarray(T)
    want = jT.at[..., 1, :].add(-dy * jT[..., 2, :])
    t = torch.from_numpy(T).requires_grad_(True)
    got = tb.rebase_tmat(t, ty0)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    cot = np.random.default_rng(1).normal(size=T.shape).astype(np.float32)
    jgrad = jax.grad(lambda x: jnp.sum(
        x.at[..., 1, :].add(-dy * x[..., 2, :]) * cot))(jT)
    (tgrad,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), t)
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))


def test_band_rows_refuses_rows_that_do_not_divide():
    assert tb.band_rows(64, None, 1) == (4, 0)
    assert tb.band_rows(96, 2, 3) == (2, 4)
    with pytest.raises(ValueError, match="3 tile rows"):
        tb.band_rows(48, 0, 2)


def test_rasterize_refuses_band_and_gaussian_sharding_together():
    from gssr_tpu_torch.ops.rasterize import rasterize
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="mutually exclusive"):
        rasterize(z, z, torch.zeros((4, 4)), torch.zeros(4), None, 32, 32,
                  torch.zeros(3), colors_precomp=z, band_rank=0,
                  band_count=1, gauss_shard=True)


def test_merge_flags_without_a_group_is_the_band_itself():
    total, over = tb.merge_flags(torch.tensor(7, dtype=torch.int32),
                                 torch.tensor(False))
    assert int(total) == 7 and not bool(over)
