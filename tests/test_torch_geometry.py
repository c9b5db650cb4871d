"""Geometry of the port against gssr_tpu: SH evaluation, quaternions,
covariances, camera matrices and the whole preprocess.

Integers must match exactly; floats at atol 1e-5, rtol 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_and_sh_to_color(deg):
    from gssr_tpu.ops import sh as jsh
    from gssr_tpu_torch.ops import sh as tsh
    rng = np.random.default_rng(deg)
    sh = rng.normal(0, 0.5, (64, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.testing.assert_allclose(
        tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy(),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))),
        **TOL)
    means = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    campos = np.array([0.3, -0.2, 4.0], np.float32)
    np.testing.assert_allclose(
        tsh.sh_to_color(deg, torch.from_numpy(sh), torch.from_numpy(means),
                        torch.from_numpy(campos)).numpy(),
        np.asarray(jsh.sh_to_color(deg, jnp.asarray(sh), jnp.asarray(means),
                                   jnp.asarray(campos))), **TOL)
    rgb = rng.uniform(0, 1, (8, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
                               **TOL)


def test_quaternions_and_covariance():
    from gssr_tpu.utils import general as jg
    from gssr_tpu_torch.utils import general as tg
    rng = np.random.default_rng(1)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-4, 0, (50, 3))).astype(np.float32)
    np.testing.assert_allclose(tg.quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               np.asarray(jg.quat_to_rotmat(jnp.asarray(q))),
                               **TOL)
    np.testing.assert_allclose(
        tg.build_covariance(torch.from_numpy(s), torch.from_numpy(q),
                            0.7).numpy(),
        np.asarray(jg.build_covariance(jnp.asarray(s), jnp.asarray(q), 0.7)),
        **TOL)
    R = np.asarray(jg.quat_to_rotmat(jnp.asarray(q[:1])))[0].astype(
        np.float64)
    np.testing.assert_allclose(tg.rotmat_to_quat(R), jg.rotmat_to_quat(R),
                               atol=1e-12)
    for step in (0, 1, 777, 30_000, 40_000):
        args = (step, 1.6e-4 * 3.3, 1.6e-6 * 3.3)
        kw = dict(lr_delay_mult=0.01, max_steps=30_000)
        assert tg.expon_lr(*args, **kw) == float(jg.expon_lr(*args, **kw))


def test_camera_matrices():
    from gssr_tpu.cameras import Camera as JCam
    from gssr_tpu.utils import graphics as jgr
    from gssr_tpu_torch.cameras import Camera as TCam
    from gssr_tpu_torch.utils import graphics as tgr
    rng = np.random.default_rng(2)
    q = rng.normal(size=4)
    from gssr_tpu.utils.general import quat_to_rotmat
    R = np.asarray(quat_to_rotmat(jnp.asarray(q, jnp.float32)), np.float64)
    kw = dict(uid=3, colmap_id=3, image_name="c", R=R,
              T=rng.normal(size=3), fovx=1.1, fovy=0.8, width=64, height=40)
    j, t = JCam(**kw), TCam(**kw)
    for f in ("w2c", "proj", "full_proj", "campos"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    ja, ta = j.arrays(), t.arrays("cpu")
    for f in ja._fields:
        np.testing.assert_array_equal(getattr(ta, f).numpy(), getattr(ja, f))
    np.testing.assert_array_equal(
        tgr.projection_matrix(0.01, 100.0, 1.1, 0.8),
        jgr.projection_matrix(0.01, 100.0, 1.1, 0.8))
    assert tgr.focal_to_fov(500.0, 640) == jgr.focal_to_fov(500.0, 640)


def _edge_inputs(seed):
    """200 gaussians, some behind the camera or inactive, some large enough
    that their rect exceeds the 32-tile intersect mask, and the camera
    (Camera keywords) of a 192 x 128 image."""
    rng = np.random.default_rng(seed)
    n = 200
    means = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    means[:10, 2] = -4.5
    scales = np.exp(rng.uniform(-4, 0.0, (n, 3))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.001, 1.0, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    kw = dict(uid=0, colmap_id=0, image_name="p", R=np.eye(3),
              T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(70),
              fovy=math.radians(50), width=192, height=128)
    return means, scales, rots, opac, active, kw


@pytest.mark.parametrize("seed", [0, 1])
def test_preprocess_matches(seed):
    from gssr_tpu.cameras import Camera as JCam
    from gssr_tpu.ops.projection import preprocess as jpre
    from gssr_tpu_torch.cameras import Camera as TCam
    from gssr_tpu_torch.ops.projection import preprocess as tpre
    means, scales, rots, opac, active, kw = _edge_inputs(seed)
    j = jpre(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(rots),
             JCam(**kw).arrays(), 192, 128, active_mask=jnp.asarray(active),
             opacity=jnp.asarray(opac))
    t = tpre(torch.from_numpy(means), torch.from_numpy(scales),
             torch.from_numpy(rots), TCam(**kw).arrays("cpu"), 192, 128,
             torch.from_numpy(opac), active_mask=torch.from_numpy(active))
    for f in ("radius", "rect", "tiles_touched", "tile_mask", "exact_tiles"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert b.dtype == np.int32, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("mean2d", "conic", "depth", "cov2d"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), err_msg=f,
                                   **TOL)
    assert (t.tiles_touched.numpy() > 32).any()     # beyond the mask window
    assert (t.tile_mask.numpy() < 0).any()          # bit 31 in use


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_mask_cpu_is_the_plain_loop(seed, monkeypatch):
    """On CPU tensors tile_intersect_mask runs tile_intersect_mask_plain and
    never reaches a kernel launch, and gives what it gives, on the mask
    inputs of test_preprocess_matches's edge cases."""
    from gssr_tpu_torch.cameras import Camera as TCam
    from gssr_tpu_torch.ops import _kernels
    from gssr_tpu_torch.ops import projection as P

    def no_launch(name, *args):
        raise AssertionError(f"a CPU call reached _kernels.launch({name})")

    plain, calls = P.tile_intersect_mask_plain, []

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(_kernels, "launch", no_launch)
    monkeypatch.setattr(P, "tile_intersect_mask_plain", spy)
    launches = dict(P.LAUNCHES)
    means, scales, rots, opac, active, kw = _edge_inputs(seed)
    t = P.preprocess(torch.from_numpy(means), torch.from_numpy(scales),
                     torch.from_numpy(rots), TCam(**kw).arrays("cpu"), 192,
                     128, torch.from_numpy(opac),
                     active_mask=torch.from_numpy(active))
    assert len(calls) == 1
    args = calls[0]
    mask, count = P.tile_intersect_mask(*args)
    want_mask, want_count = plain(*args)
    assert len(calls) == 2 and P.LAUNCHES == launches
    assert torch.equal(mask, want_mask) and torch.equal(count, want_count)
    assert torch.equal(mask, t.tile_mask)
    # the edge cases the inputs hold: rects past 32 tiles, bit 31 set,
    # behind-camera and inactive slots culled to 0 / 0
    visible = args[4]
    assert (count > 32).any() and (mask < 0).any()
    assert not visible[:10].any() and not visible[10:][~torch.from_numpy(
        active[10:])].any()
    assert not mask[~visible].any() and not count[~visible].any()
