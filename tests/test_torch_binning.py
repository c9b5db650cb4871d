"""The port's tile binning against gssr_tpu's chunked bin_gaussians.

The port sizes its instance buffer exactly (no overflow), the reference to
a static capacity; so layout arrays are compared over the live range:
tile ranges and segment bounds exactly, the port's buffer length against
the reference's live-chunk count, and the sorted gaussian ids and hit
flags exactly over the live slots. Inputs have no depth-key ties, so the
order within a tile is unique.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch

CAP = 8192


W, H = 128, 96


@functools.lru_cache(maxsize=1)
def _jax_fns():
    from gssr_tpu.cameras import Camera
    from gssr_tpu.ops.binning import bin_gaussians
    from gssr_tpu.ops.projection import preprocess
    cam = Camera(uid=0, colmap_id=0, image_name="b", R=np.eye(3),
                 T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(70),
                 fovy=math.radians(55), width=W, height=H).arrays()
    prep = jax.jit(lambda m, s, r, o: preprocess(m, s, r, cam, W, H,
                                                 opacity=o))
    binning = jax.jit(lambda rect, depth, tiles, mask: bin_gaussians(
        rect, depth, tiles, W // 16, H // 16, CAP, chunk=128,
        tile_mask=mask))
    return prep, binning


def _projected(n, seed):
    rng = np.random.default_rng(seed)
    proj = _jax_fns()[0](
        np.asarray(rng.uniform(-2, 2, (n, 3)), np.float32),
        np.asarray(np.exp(rng.uniform(-4, -1, (n, 3))), np.float32),
        np.asarray(rng.normal(size=(n, 4)), np.float32),
        np.asarray(rng.uniform(0.05, 1.0, n), np.float32))
    return tuple(np.array(x) for x in (proj.rect, proj.depth,
                                       proj.tiles_touched, proj.tile_mask))


@pytest.mark.parametrize("n,seed", [(300, 0), (40, 1), (0, 2)])
def test_bin_gaussians_matches(n, seed):
    from gssr_tpu_torch.ops.binning import bin_gaussians as tbin
    rect, depth, tiles, mask = _projected(max(n, 8), seed)
    if n == 0:    # nothing visible at all
        tiles = np.zeros_like(tiles)
    j = _jax_fns()[1](rect, depth, tiles, mask)
    t = tbin(*(torch.from_numpy(x) for x in (rect, depth, tiles)), W // 16,
             H // 16, torch.from_numpy(mask), chunk=128)
    assert not bool(j.overflow) and not bool(t.overflow)
    n_live = int(j.n_live_chunks[0])
    assert t.gauss_id.shape[0] == max(n_live, 1) * 128
    live = n_live * 128
    for f in ("tile_ranges", "seg_bounds", "tile_counts", "num_rendered"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("gauss_id", "hit", "gid_reduce"):
        np.testing.assert_array_equal(getattr(t, f).numpy()[:live],
                                      np.asarray(getattr(j, f))[:live],
                                      err_msg=f)
    if n:
        hits = t.hit.numpy()
        assert 0 < hits.sum() < live        # real hits and filler / culled
