"""The port's full rasterizer (gssr_tpu_torch.ops.rasterize, on the CPU
through the blend kernels' plain versions) against gssr_tpu's
rasterize(backend="pallas") in interpret mode: image, final_T and the
gradients of every input, on the shapes of tests/test_check_grads.py.

Tolerances are the reference's own (tests/test_blend_pallas.py): forward
atol 1e-5 / rtol 1e-4, gradients atol 2e-4 / rtol 2e-3.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H = 48, 32
N = 24


def _cam_kwargs():
    return dict(uid=0, colmap_id=0, image_name="fd", R=np.eye(3),
                T=np.array([0.0, 0.0, 3.0]), fovx=math.radians(70),
                fovy=math.radians(55), width=W, height=H)


def _scene(kind):
    """numpy inputs (means, scales, rots, opac, sh) made from a seed."""
    rng = np.random.default_rng({"cloud": 0, "alpha_clamp": 3,
                                 "t_stop": 4}[kind])
    if kind == "t_stop":
        # a deep stack of near-opaque splats drives T through the 1e-4
        # stop mid-chunk
        means = np.stack([rng.uniform(-0.2, 0.2, N), rng.uniform(-0.2, 0.2, N),
                          np.linspace(0.0, 1.0, N)], axis=1)
        scales = np.exp(rng.uniform(-1.5, -1.0, (N, 3)))
        opac = rng.uniform(0.90, 0.985, N)
    elif kind == "alpha_clamp":
        # peak alpha saturates the 0.99 clamp
        means = rng.uniform(-0.5, 0.5, (N, 3))
        scales = np.exp(rng.uniform(-1.2, -0.8, (N, 3)))
        opac = rng.uniform(0.995, 1.0, N)
    else:
        means = rng.uniform(-1.5, 1.5, (N, 3))
        scales = np.exp(rng.uniform(-3.0, -1.8, (N, 3)))
        opac = rng.uniform(0.25, 0.85, N)
    rots = rng.normal(size=(N, 4))
    sh = rng.normal(0, 0.3, (N, 4, 3))
    f32 = lambda x: np.asarray(x, np.float32)
    return tuple(map(f32, (means, scales, rots, opac, sh)))


@functools.lru_cache(maxsize=1)
def _jax_grad_fn():
    from gssr_tpu.cameras import Camera
    from gssr_tpu.ops.rasterize import rasterize
    cam = Camera(**_cam_kwargs()).arrays()

    def loss(means, scales, rots, opac, sh, off, wimg):
        out = rasterize(means, scales, rots, opac, cam, W, H,
                        jnp.asarray([0.1, 0.2, 0.3], jnp.float32),
                        sh_coeffs=sh, sh_degree=1, instance_cap=4096,
                        backend="pallas", mean2d_offset=off)
        return (jnp.sum(out.image * wimg) + 0.3 * jnp.sum(out.final_T),
                (out.image, out.final_T, out.radii, out.num_rendered))

    return jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                      has_aux=True))


@pytest.mark.parametrize("kind", ["cloud", "alpha_clamp", "t_stop"])
def test_rasterize_matches_gssr_tpu(kind):
    from gssr_tpu_torch.cameras import Camera
    from gssr_tpu_torch.ops.rasterize import rasterize

    inputs = _scene(kind)
    wimg = np.random.default_rng(7).normal(size=(H, W, 3)).astype(np.float32)
    off = np.zeros((N, 2), np.float32)
    (_, (img_j, T_j, radii_j, nr_j)), g_j = _jax_grad_fn()(
        *inputs, off, wimg)

    ts = [torch.tensor(x, requires_grad=True) for x in inputs + (off,)]
    out = rasterize(*ts[:4], Camera(**_cam_kwargs()).arrays("cpu"), W, H,
                    torch.tensor([0.1, 0.2, 0.3]), sh_coeffs=ts[4],
                    sh_degree=1, mean2d_offset=ts[5])
    loss = (out.image * torch.from_numpy(wimg)).sum() + 0.3 * out.final_T.sum()
    g_t = torch.autograd.grad(loss, ts)

    np.testing.assert_allclose(out.image.detach().numpy(), np.asarray(img_j),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out.final_T.detach().numpy(), np.asarray(T_j),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(radii_j))
    assert int(out.num_rendered) == int(nr_j)
    names = ["means", "scales", "rots", "opac", "sh", "mean2d_offset"]
    for name, a, b in zip(names, g_j, g_t):
        a = np.asarray(a)
        assert np.abs(a).max() > 0, name           # the gradient is real
        np.testing.assert_allclose(b.numpy(), a, atol=2e-4, rtol=2e-3,
                                   err_msg=name)
