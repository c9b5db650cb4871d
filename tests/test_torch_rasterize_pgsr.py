"""The port's planar rasterizer (gssr_tpu_torch.ops.rasterize_pgsr, on the
CPU through the planar kernels' plain versions) and the sampling
primitives of the PGSR losses against gssr_tpu's, in interpret mode.

Tolerances: maps atol 1e-5 / rtol 1e-4, plane depth 2e-4 of its largest
value (it divides by n . ray + 1e-8, huge where the blended normal is
nearly orthogonal to the ray), observe counts and radii exactly;
gradients each leaf to 2e-4 of its largest value; the sampling
primitives atol = rtol = 1e-5.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

BG = (0.05, 0.1, 0.15)


def _cam_kwargs(w, h):
    return dict(uid=0, colmap_id=0, image_name="t", R=np.eye(3),
                T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(60),
                fovy=math.radians(60), width=w, height=h)


def _scene(n, seed=0):
    """tests/test_pgsr.py's random_scene, in numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)               # noqa: E731
    return tuple(map(f32, (rng.uniform(-1.5, 1.5, (n, 3)),
                           rng.uniform(0.02, 0.3, (n, 3)),
                           rng.normal(size=(n, 4)),
                           rng.uniform(0.2, 1.0, n),
                           rng.uniform(0, 1, (n, 3)))))


def _t_cam(w, h):
    from gssr_tpu_torch.cameras import Camera
    return Camera(**_cam_kwargs(w, h)).arrays("cpu")


def _j_cam(w, h):
    from gssr_tpu.cameras import Camera
    return Camera(**_cam_kwargs(w, h)).arrays()


@functools.lru_cache(maxsize=None)
def _jax_render(w, h):
    from gssr_tpu.ops.rasterize_pgsr import rasterize_pgsr
    cam = _j_cam(w, h)

    @jax.jit
    def fn(means, scales, rots, opac, colors, bg):
        return rasterize_pgsr(means, scales, rots, opac, cam, w, h, bg,
                              colors_precomp=colors, backend="pallas",
                              instance_cap=2048)
    return fn


def _t_render(scene, w, h, bg=BG, **hooks):
    from gssr_tpu_torch.ops.rasterize_pgsr import rasterize_pgsr
    m, s, r, o, c = scene
    return rasterize_pgsr(m, s, r, o, _t_cam(w, h), w, h, torch.tensor(bg),
                          colors_precomp=c, **hooks)


@pytest.mark.parametrize("n", [1, 32])
def test_maps_match_pallas(n):
    scene = _scene(n, seed=n)
    j = _jax_render(32, 16)(*scene, jnp.asarray(BG, jnp.float32))
    t = _t_render(tuple(map(torch.from_numpy, scene)), 32, 16)
    for f in ("image", "final_T", "alpha", "normal", "distance"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), atol=1e-5,
                                   rtol=1e-4, err_msg=f)
    pd = np.asarray(j.plane_depth)
    np.testing.assert_allclose(t.plane_depth.numpy(), pd, rtol=0,
                               atol=2e-4 * np.abs(pd).max())
    for f in ("observe", "radii"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert int(t.num_rendered) == int(j.num_rendered)
    assert float(t.alpha.max()) > 0.1 and float(t.observe.sum()) > 0


def _loss(out, tgt):
    """tests/test_pgsr.py:72-75."""
    return ((out.image - tgt) ** 2).mean() + 0.05 * (out.normal ** 2).mean() \
        + 0.01 * out.distance.mean() + 0.01 * out.final_T.mean()


def test_gradients_and_hooks_match_pallas():
    """Every leaf's gradient, the abs screen gradients (mean2d_abs_offset)
    and the observe side channel (observe_offset) against gssr_tpu's; the
    side channel also equals the port's forward observe count."""
    from gssr_tpu.ops.rasterize_pgsr import rasterize_pgsr as jr
    rng = np.random.default_rng(0)
    scene = _scene(12, seed=12)
    tgt = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    cam = _j_cam(16, 16)

    def jloss(means, scales, rots, opac, colors, m2d_abs, obs_off):
        out = jr(means, scales, rots, opac, cam, 16, 16, jnp.zeros(3),
                 colors_precomp=colors, backend="pallas", instance_cap=512,
                 mean2d_abs_offset=m2d_abs, observe_offset=obs_off)
        return _loss(out, tgt)

    g_j = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(
        *scene, np.zeros((12, 2), np.float32), np.zeros((12, 1), np.float32))
    ts = [torch.tensor(x, requires_grad=True) for x in scene]
    hooks = dict(mean2d_abs_offset=torch.zeros(12, 2, requires_grad=True),
                 observe_offset=torch.zeros(12, 1, requires_grad=True))
    out = _t_render(ts, 16, 16, bg=(0.0,) * 3, **hooks)
    g_t = torch.autograd.grad(_loss(out, torch.from_numpy(tgt)),
                              ts + list(hooks.values()))
    names = ("means", "scales", "rots", "opac", "colors", "abs", "observe")
    for name, a, b in zip(names, g_j, g_t):
        a, b = np.asarray(a), b.numpy()
        assert np.isfinite(b).all(), name
        assert np.abs(a).max() > 1e-4, name                # a live leaf
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=2e-4 * np.abs(a).max(), err_msg=name)
    np.testing.assert_array_equal(g_t[-1][:, 0].numpy(),
                                  out.observe.numpy())


def test_a_training_render_leaves_the_observe_kernel_out():
    from gssr_tpu_torch.ops.rasterize_pgsr import rasterize_pgsr
    m, s, r, o, c = map(torch.from_numpy, _scene(8))
    out = rasterize_pgsr(m, s, r, o, _t_cam(16, 16), 16, 16, torch.zeros(3),
                         colors_precomp=c, forward_observe=False)
    assert out.observe is None and float(out.alpha.max()) > 0


def test_gaussian_plane_normals_match():
    from gssr_tpu.ops.rasterize_pgsr import gaussian_plane_normals as jn
    from gssr_tpu_torch.ops.rasterize_pgsr import gaussian_plane_normals as tn
    means, scales, rots, _, _ = _scene(64, seed=3)
    campos = np.array([0.3, -0.2, -4.0], np.float32)
    j = jn(means, scales, rots, campos)
    t = tn(*map(torch.from_numpy, (means, scales, rots, campos)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                               rtol=1e-5)


def test_lncc_erode_and_image_grad_weight_match():
    from gssr_tpu.ops import sampling as js
    from gssr_tpu_torch.ops import sampling as ts
    rng = np.random.default_rng(1)
    ref = rng.uniform(0, 1, (40, 49)).astype(np.float32)
    nea = (0.7 * ref + 0.3 * rng.uniform(0, 1, ref.shape)).astype(np.float32)
    nea[:5] = ref[:5]                        # perfectly correlated patches
    for a, b in zip(js.lncc(ref, nea), ts.lncc(torch.from_numpy(ref),
                                                 torch.from_numpy(nea))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-5)
    img = rng.uniform(0, 1, (20, 24, 3)).astype(np.float32)
    w = np.array(js.image_grad_weight(img))
    np.testing.assert_allclose(
        ts.image_grad_weight(torch.from_numpy(img)).numpy(), w, atol=1e-5,
        rtol=1e-5)
    np.testing.assert_allclose(ts.erode(torch.tensor(w)).numpy(),
                               np.asarray(js.erode(w)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        ts.rgb_to_gray(torch.from_numpy(img)).numpy(),
        np.asarray(js.rgb_to_gray(img)), atol=1e-5, rtol=1e-5)


def test_patch_warp_and_bilinear_gradients_match():
    """The homography warp and the bilinear taps, value and gradient with
    respect to the image and the coordinates, with coordinates exactly on
    the border (where jnp.clip splits a gradient between its two sides)
    and outside it."""
    from gssr_tpu.ops import sampling as js
    from gssr_tpu_torch.ops import sampling as ts
    rng = np.random.default_rng(2)
    H, W = 12, 14
    img = rng.uniform(0, 2, (H, W)).astype(np.float32)
    offs = np.asarray(js.patch_offsets(2))
    np.testing.assert_array_equal(ts.patch_offsets(2).numpy(), offs)
    uv = (rng.uniform(0, W - 1, (30, 1, 2)) + offs[None]).astype(np.float32)
    uv[0, :, 0] = 0.0
    uv[1, :, 0] = W - 1.0
    uv[2, :, 1] = H - 1.0
    Hm = (np.eye(3) + rng.normal(0, 0.02, (30, 3, 3))).astype(np.float32)
    cot = rng.normal(size=(30, len(offs))).astype(np.float32)

    def jf(img, Hm, uv):
        return jnp.sum(js.bilinear_sample(img, js.patch_warp(Hm, uv)) * cot)

    def jf_direct(img, uv):
        return jnp.sum(js.bilinear_sample(img, uv) * cot)

    g_j = jax.grad(jf, argnums=(0, 1, 2))(img, Hm, uv)
    g_jd = jax.grad(jf_direct, argnums=(0, 1))(img, uv)
    t = [torch.tensor(x, requires_grad=True) for x in (img, Hm, uv)]
    warped = ts.patch_warp(t[1], t[2])
    np.testing.assert_allclose(warped.detach().numpy(),
                               np.asarray(js.patch_warp(Hm, uv)), atol=1e-5,
                               rtol=1e-5)
    g_t = torch.autograd.grad(
        (ts.bilinear_sample(t[0], warped) * torch.from_numpy(cot)).sum(), t)
    g_td = torch.autograd.grad(
        (ts.bilinear_sample(t[0], t[2]) * torch.from_numpy(cot)).sum(),
        [t[0], t[2]])
    # gradients to 1e-5 of each one's largest value: d/dH reaches ~30
    for a, b in list(zip(g_j, g_t)) + list(zip(g_jd, g_td)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5,
                                   atol=1e-5 * np.abs(a).max())


def test_texel_gather_backward_is_the_per_texel_sum():
    """bilinear_sample's image gradient (the sorted segment sum) equals an
    index_add in float64 and is bitwise reproducible."""
    from gssr_tpu_torch.ops.sampling import bilinear_sample
    rng = np.random.default_rng(4)
    img = torch.tensor(rng.uniform(0, 1, (9, 11)).astype(np.float32),
                       requires_grad=True)
    xy = torch.from_numpy(rng.uniform(-1, 12, (500, 2)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=500).astype(np.float32))

    def grad():
        return torch.autograd.grad((bilinear_sample(img, xy) * cot).sum(),
                                   img)[0]
    g = grad()
    x = torch.clamp(xy[:, 0], 0, 10)
    y = torch.clamp(xy[:, 1], 0, 8)
    x0, y0 = torch.clamp(x.floor(), 0, 9), torch.clamp(y.floor(), 0, 7)
    wx, wy = (x - x0).double(), (y - y0).double()
    c = cot.double()
    ref = torch.zeros(99, dtype=torch.float64)
    base = (y0 * 11 + x0).long()
    for k, w in ((0, (1 - wx) * (1 - wy)), (1, wx * (1 - wy)),
                 (11, (1 - wx) * wy), (12, wx * wy)):
        ref.index_add_(0, base + k, c * w)
    np.testing.assert_allclose(g.numpy().ravel(), ref.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(g, grad())
