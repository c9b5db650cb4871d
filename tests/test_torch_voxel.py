"""The port's voxel helpers (gssr_tpu_torch/ops/voxel.py) against gssr_tpu's
on the same numpy inputs: hash keys, dedup runs, segment maxima and the
voxelised init points, all exactly. The anchor growing of the scaffold
models rests on them: a key that differed would change which candidate
anchors survive the dedup."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _coords(seed):
    rng = np.random.default_rng(seed)
    c = rng.integers(-2 ** 31, 2 ** 31 - 1, (4096, 3), dtype=np.int64)
    small = rng.integers(-300, 300, (4096, 3))
    c = np.concatenate([c, small]).astype(np.int32)
    c[:6] = [[0, 0, 0], [-1, -1, -1], [2 ** 31 - 1] * 3, [-2 ** 31] * 3,
             [1, 2, 3], [-7, 0, 2 ** 30]]
    return c


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_keys_equal(seed):
    from gssr_tpu.ops import voxel as J
    from gssr_tpu_torch.ops import voxel as T
    c = _coords(seed)
    want = np.asarray(J.hash_coords(jnp.asarray(c)))
    got = T.hash_coords(torch.from_numpy(c)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got < T.KEY_MAX).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_runs_and_segment_max_equal(seed):
    """Candidates with many repeated keys, some invalid, some already
    present among the existing keys (sorted, padded with KEY_MAX)."""
    from gssr_tpu.ops import voxel as J
    from gssr_tpu_torch.ops import voxel as T
    rng = np.random.default_rng(seed)
    n = 2000
    keys = rng.integers(0, 300, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    existing = np.sort(np.concatenate([
        rng.choice(300, 40, replace=False).astype(np.int32),
        np.full(24, T.KEY_MAX, np.int32)]))
    feats = rng.normal(size=(n, 5)).astype(np.float32)

    dj = J.dedup_against(jnp.asarray(keys), jnp.asarray(valid),
                         jnp.asarray(existing))
    dt = T.dedup_against(torch.from_numpy(keys), torch.from_numpy(valid),
                         torch.from_numpy(existing))
    for name in ("order", "sorted_keys", "is_new", "seg_id"):
        np.testing.assert_array_equal(getattr(dt, name).numpy(),
                                      np.asarray(getattr(dj, name)),
                                      err_msg=name)
    assert 0 < int(dt.is_new.sum()) < n

    order = np.asarray(dj.order)
    mj = J.segment_max_sorted(jnp.asarray(feats[order]), dj.seg_id, n)
    mt = T.segment_max_sorted(torch.from_numpy(feats[order]), dt.seg_id, n)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


@pytest.mark.parametrize("voxel", [0.1, 0.013])
def test_voxelized_points_equal(voxel):
    from gssr_tpu.ops import voxel as J
    from gssr_tpu_torch.ops import voxel as T
    pts = np.random.default_rng(3).uniform(-1, 1, (3000, 3))
    np.testing.assert_array_equal(T.voxelize_points_host(pts, voxel),
                                  J.voxelize_points_host(pts, voxel))
