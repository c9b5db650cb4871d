"""The port's tile blend against gssr_tpu's Pallas blend (interpret mode).

`blend` runs the instance pack and `_BlendCore`, which on the CPU takes
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
    """CUDA kernels against their plain versions on the same inputs; the
    backward and its first design (blend_bwd_v1) also against each other,
    bit for bit."""
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
    assert torch.equal(d_k, B.blend_bwd_v1(attrs, tb.tile_ranges, out_k, cot,
                                           w // 16, h // 16))
