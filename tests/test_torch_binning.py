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


# chip_smoke.expand_cases' inputs, which the card holds the expansion
# kernel to as well
EXPAND_CASES = ["n = 0", "all culled", "random", "no mask", "wide rects",
                "sparse", "band"]


def _expand_reference(rect, depth, tiles, mask, tiles_x, tiles_y, key_tiles,
                      chunk=128):
    """duplicateWithKeys in numpy, one run at a time: each visible
    gaussian writes its rect's tiles in row-major order, then each tile its
    padding, then tile 0 fills what is left of the minimum buffer.
    Returns expand_instances' arguments and the (key, payload) it must
    give."""
    rect, tiles = rect.numpy().astype(np.int64), tiles.numpy()
    n, num_tiles = len(tiles), tiles_x * tiles_y
    depth_bits = 32 - max(1, int((key_tiles or num_tiles) + 1).bit_length())
    ones = (1 << depth_bits) - 1
    dq = (depth.numpy().view(np.int32).astype(np.int64)
          >> (31 - depth_bits)) & ones
    bits = None if mask is None else mask.numpy().view(np.uint32)
    real = []
    for g in range(n):
        x0, y0, x1, _ = rect[g]
        for local in range(int(tiles[g])):
            tile = (y0 + local // (x1 - x0)) * tiles_x + x0 + local % (x1 - x0)
            hit = 1 if bits is None or local >= 32 else (bits[g] >> local) & 1
            real.append((tile, (tile << depth_bits) | dq[g],
                         g | int(hit) << 30 | 1 << 29))
    counts = np.bincount([r[0] for r in real], minlength=num_tiles)
    pads = -counts % chunk
    cap = max(int(counts.sum() + pads.sum()), chunk)
    key = np.full(cap, ones, np.int64)        # tile 0 past every run
    payload = np.zeros(cap, np.int64)
    key[:len(real)] = [r[1] for r in real]
    payload[:len(real)] = [r[2] for r in real]
    s = len(real)
    for t in range(num_tiles):
        key[s:s + pads[t]] = (t << depth_bits) | ones
        s += pads[t]
    key = (key ^ (1 << 31)).astype(np.uint32).view(np.int32)
    nr = int(tiles.sum())
    args = (torch.from_numpy(rect.astype(np.int32)), depth, mask,
            torch.from_numpy(np.cumsum(tiles).astype(np.int32)),
            torch.from_numpy((nr + np.concatenate([[0], np.cumsum(pads)]))
                             .astype(np.int32)),
            torch.tensor(nr, dtype=torch.int32), cap, tiles_x, depth_bits)
    return args, key, payload.astype(np.int32)


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_instances_plain_matches_duplicate_with_keys(case):
    """expand_instances_plain, the CPU path and the card's reference,
    against an independent per-gaussian expansion; and bin_gaussians hands
    it the same arguments the expansion takes from first principles."""
    from chip_smoke import expand_cases, expand_inputs
    from gssr_tpu_torch.ops.binning import expand_instances_plain
    inputs = expand_cases()[case]
    args, key, payload = _expand_reference(*inputs)
    got = expand_inputs(inputs, torch.device("cpu"))
    for a, b in zip(got, args):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert a == b
    k, p = expand_instances_plain(*args)
    np.testing.assert_array_equal(k.numpy(), key)
    np.testing.assert_array_equal(p.numpy(), payload)


def test_cpu_binning_launches_no_kernel():
    """CPU tensors take the plain chain, through bin_gaussians and through
    expand_instances itself: the launch counters stay where they were."""
    from chip_smoke import expand_cases, expand_inputs
    from gssr_tpu_torch.ops import binning as B
    case = expand_cases()["random"]
    rect, depth, tiles, mask, tiles_x, tiles_y, _ = case
    before = dict(B.LAUNCHES)
    out = B.bin_gaussians(rect, depth, tiles, tiles_x, tiles_y, mask)
    args = expand_inputs(case, torch.device("cpu"))
    for a, b in zip(B.expand_instances(*args),
                    B.expand_instances_plain(*args)):
        assert torch.equal(a, b)
    assert B.LAUNCHES == before
    assert int(out.num_rendered) == int(tiles.sum()) > 0
