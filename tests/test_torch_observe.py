"""The planar observe count's plain version (ops/blend_pgsr.py::
blend_pgsr_obs_plain, the oracle of csrc/blend_pgsr.cu::
blend_pgsr_obs_kernel) against gssr_tpu's _obsp_kernel in interpret mode,
exactly, on chip_smoke.py::observe_cases: stacks built by hand so that D
reaches exactly 0.5, the 0.5 point falls on either side of a chunk
boundary, a warp is done while its neighbours walk, and a tile never
reaches 0.5. The kernel stops each pixel, warp and tile at the 0.5 point;
these are the cases where a stop in the wrong place would change a
count. The same stacks run against the kernel on the card in chip_smoke
phase 2 and in the cuda-marked test below."""
import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import assert_observe_cases, observe_cases  # noqa: E402


@functools.lru_cache(maxsize=None)
def _jax_obs(tiles_x, tiles_y):
    from gssr_tpu.ops.blend_pgsr_pallas import _run_obsp
    return jax.jit(functools.partial(_run_obsp, tiles_x=tiles_x,
                                     tiles_y=tiles_y))


def _chunk_map(ranges, chunk=128):
    """gssr_tpu's flat chunk grid: the tile of every live chunk, in order,
    and how many there are."""
    r = ranges.numpy()
    cmap = np.concatenate([np.full((r[t + 1] - r[t]) // chunk, t, np.int32)
                           for t in range(len(r) - 1)])
    return cmap, np.asarray([len(cmap)], np.int32)


def _scaled(attrs, scale):
    """The stacks with every opacity scaled (kept within 0.99): the same
    cases a step further from or closer to the 0.5 point."""
    a = attrs.clone()
    a[5] = torch.clamp(a[5] * scale, max=0.99)
    return a


@pytest.mark.parametrize("scale", [1.0, 0.97, 1.03])
def test_observe_cases_equal_gssr_tpu(scale):
    from gssr_tpu_torch.ops import blend_pgsr as B
    attrs, ranges, tx, ty, want = observe_cases()
    attrs = _scaled(attrs, scale)
    cmap, nlive = _chunk_map(ranges)
    obs_j = np.asarray(_jax_obs(tx, ty)(attrs.numpy(), cmap, nlive))[0]
    obs_t = B.blend_pgsr_observe(attrs, ranges, tx, ty)
    np.testing.assert_array_equal(obs_t.numpy(), obs_j)
    if scale == 1.0:
        assert_observe_cases(obs_t, ranges, want)
    else:
        assert obs_t.sum() > 0


def test_observe_cases_hit_every_case():
    """What the stacks are built to show, read off the plain version's
    transmittance walk: D exactly 0.5 in tile 0, the crossing instance at
    slot 127 of tile 1 and slot 128 of tile 2, tile 3's first warp done
    after one instance while other pixels stay above 0.5, tile 4 above
    0.5 at its end."""
    from gssr_tpu_torch.ops.blend import _chunk_alpha, _chunks, _walk
    from gssr_tpu_torch.ops.blend import _pixel_coords
    attrs, ranges, tx, ty, _ = observe_cases()
    px, py = _pixel_coords(tx, ty, "cpu")
    D = torch.ones_like(px)
    befores = []
    for A, _, _ in _chunks(attrs[:6], ranges):
        a, _ = _chunk_alpha(A, px, py)
        _, d_before, _, _, D = _walk(a, D)
        befores.append(d_before)
    d = torch.cat(befores, dim=2)             # [tiles, pixels, slot]
    assert bool((d[0, :, 1] == 0.5).all())
    for t, slot in ((1, 127), (2, 128)):
        assert bool((d[t, :, slot] > 0.5).all())
        assert bool((d[t, :, slot + 1] <= 0.5).all())
    warp0 = (py[3] < 16 + 4) & (px[3] < 8)
    assert bool((d[3, warp0, 1] <= 0.5).all())
    assert bool((d[3, ~warp0, 1] > 0.5).any())
    assert bool((D[4] > 0.5).all())
    assert int(ranges[6] - ranges[5]) == 0


@pytest.mark.cuda
def test_observe_kernel_equals_plain_on_the_card():
    """The kernel against its plain version on the same stacks (the card
    only: a CUDA kernel has no interpret mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this comparison "
                    "there")
    from gssr_tpu_torch.ops import blend_pgsr as B
    dev = torch.device("cuda")
    attrs, ranges, tx, ty, want = observe_cases()
    for scale in (1.0, 0.97, 1.03):
        a, r = _scaled(attrs, scale).to(dev), ranges.to(dev)
        obs_k = B.blend_pgsr_observe(a, r, tx, ty)
        assert torch.equal(obs_k, B.blend_pgsr_obs_plain(a, r, tx, ty))
        if scale == 1.0:
            assert_observe_cases(obs_k.cpu(), ranges, want)
