"""The port's surfel rasterizer (gssr_tpu_torch.ops.rasterize2d, on the CPU
through the surfel kernels' plain versions) against gssr_tpu's
rasterize_2d(backend="pallas") in interpret mode: preprocess_2d, the
binning without a tile mask, every map, and the gradients under the two
losses of tests/test_blend2d.py, on that file's shapes.

Tolerances: preprocess atol = rtol = 1e-5 and integers exact; maps
atol 1e-5 / rtol 1e-4 and the median's position exactly; gradients
atol 2e-4 / rtol 2e-3 (tests/test_blend_pallas.py's).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

BG = (0.05, 0.1, 0.15)
MAPS = ("image", "final_T", "alpha", "normal", "depth_expected",
        "median_depth", "surf_depth", "dist", "median_normal")


def _cam_kwargs(w, h):
    return dict(uid=0, colmap_id=0, image_name="t", R=np.eye(3),
                T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(60),
                fovy=math.radians(60), width=w, height=h)


def _scene(n, seed=0):
    """tests/test_blend2d.py's random_scene, in numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (n, 3))
    scales = rng.uniform(0.05, 0.4, (n, 2))
    rots = rng.normal(size=(n, 4))
    opac = rng.uniform(0.2, 1.0, n)
    colors = rng.uniform(0, 1, (n, 3))
    f32 = lambda x: np.asarray(x, np.float32)               # noqa: E731
    return tuple(map(f32, (means, scales, rots, opac, colors)))


def _t_cam(w, h):
    from gssr_tpu_torch.cameras import Camera
    return Camera(**_cam_kwargs(w, h)).arrays("cpu")


@functools.lru_cache(maxsize=None)
def _jax_render(w, h, ratio):
    from gssr_tpu.cameras import Camera
    from gssr_tpu.ops.rasterize2d import rasterize_2d
    cam = Camera(**_cam_kwargs(w, h)).arrays()

    @jax.jit
    def fn(means, scales, rots, opac, colors, bg):
        return rasterize_2d(means, scales, rots, opac, cam, w, h, bg,
                            colors_precomp=colors, backend="pallas",
                            instance_cap=4096, depth_ratio=ratio)
    return fn


def _t_render(scene, w, h, ratio=0.0, bg=BG):
    from gssr_tpu_torch.ops.rasterize2d import rasterize_2d
    m, s, r, o, c = scene
    return rasterize_2d(m, s, r, o, _t_cam(w, h), w, h, torch.tensor(bg),
                        colors_precomp=c, depth_ratio=ratio)


@pytest.mark.parametrize("n", [1, 32])
def test_preprocess_2d_matches(n):
    from gssr_tpu.cameras import Camera
    from gssr_tpu.ops.projection2d import preprocess_2d as jprep
    from gssr_tpu_torch.ops.projection2d import preprocess_2d as tprep
    m, s, r, o, _ = _scene(n, seed=n)
    cam = Camera(**_cam_kwargs(32, 16)).arrays()
    j = jax.jit(lambda m, s, r, o: jprep(m, s, r, cam, 32, 16, opacity=o))(
        m, s, r, o)
    t = tprep(*map(torch.from_numpy, (m, s, r)), _t_cam(32, 16), 32, 16,
              torch.from_numpy(o))
    for f in ("mean2d", "Tmat", "normal", "depth"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), atol=1e-5,
                                   rtol=1e-5, err_msg=f)
    for f in ("radius", "rect", "tiles_touched"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert int(t.tiles_touched.sum()) > 0


def test_binning_without_a_tile_mask_matches():
    """With tile_mask=None every rect slot of a real instance is a hit and
    fillers are not, as in gssr_tpu's binning."""
    from gssr_tpu.cameras import Camera
    from gssr_tpu.ops.binning import bin_gaussians as jbin
    from gssr_tpu.ops.projection2d import preprocess_2d as jprep
    from gssr_tpu_torch.ops.binning import bin_gaussians as tbin
    w, h = 64, 48
    m, s, r, o, _ = _scene(60, seed=3)
    cam = Camera(**_cam_kwargs(w, h)).arrays()
    proj = jax.jit(lambda m, s, r, o: jprep(m, s, r, cam, w, h,
                                            opacity=o))(m, s, r, o)
    args = [np.array(x) for x in (proj.rect, proj.depth, proj.tiles_touched)]
    j = jax.jit(lambda *a: jbin(*a, w // 16, h // 16, 8192, chunk=128))(
        *args)
    t = tbin(*map(torch.from_numpy, args), w // 16, h // 16, chunk=128)
    live = int(j.n_live_chunks[0]) * 128
    assert t.gauss_id.shape[0] == live
    for f in ("tile_ranges", "seg_bounds", "tile_counts", "num_rendered"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("gauss_id", "hit", "gid_reduce"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f))[:live],
                                      err_msg=f)
    # every real slot is a hit, every filler is not
    assert int(t.hit.sum()) == int(t.num_rendered) < live


@pytest.mark.parametrize("n", [1, 32])
def test_maps_match_pallas(n):
    scene = _scene(n)
    j = _jax_render(32, 16, 0.0)(*scene, jnp.asarray(BG, jnp.float32))
    t = _t_render(tuple(map(torch.from_numpy, scene)), 32, 16)
    for f in MAPS:
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), atol=1e-5,
                                   rtol=1e-4, err_msg=f)
    for f in ("median_contrib", "radii"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert int(t.num_rendered) == int(j.num_rendered)
    assert float(t.alpha.max()) > 0.1


def _loss_image(out, tgt):
    """tests/test_blend2d.py:93-100."""
    return ((out.image - tgt) ** 2).mean() + 0.05 * out.dist.mean() \
        + 0.02 * (out.normal * out.normal).mean() \
        + 0.01 * out.depth_expected.mean() + 0.01 * out.final_T.mean()


def _loss_median(out, tgt):
    """tests/test_blend2d.py:124-127."""
    return (out.median_normal * tgt).mean() + 0.05 * out.median_depth.mean()


@pytest.mark.parametrize("loss_name", ["image", "median"])
def test_gradients_match_pallas(loss_name):
    loss = {"image": _loss_image, "median": _loss_median}[loss_name]
    rng = np.random.default_rng(0)
    scene = _scene(12, seed=12)
    if loss_name == "image":
        tgt = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
        # every leaf carries a gradient
        live = ("means", "scales", "rots", "opac", "colors")
    else:
        tgt = rng.normal(size=(16, 16, 3)).astype(np.float32)
        # the median's normal and depth move with position and rotation
        live = ("means", "rots")
    render = _jax_render(16, 16, 0.0)
    g_j = jax.jit(jax.grad(lambda *a: loss(render(*a, jnp.zeros(
        3, jnp.float32)), tgt), argnums=(0, 1, 2, 3, 4)))(*scene)
    ts = [torch.tensor(x, requires_grad=True) for x in scene]
    g_t = torch.autograd.grad(loss(_t_render(ts, 16, 16, bg=(0.0,) * 3),
                                   torch.from_numpy(tgt)), ts,
                              allow_unused=True)
    names = ("means", "scales", "rots", "opac", "colors")
    for name, a, b in zip(names, g_j, g_t):
        a = np.asarray(a)
        b = np.zeros_like(a) if b is None else b.numpy()
        assert np.isfinite(b).all(), name
        if name in live:
            assert np.abs(a).max() > 1e-4, name
        np.testing.assert_allclose(b, a, atol=2e-4, rtol=2e-3, err_msg=name)
