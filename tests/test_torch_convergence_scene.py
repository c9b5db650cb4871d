"""The long run's scene (`chip_smoke.py --convergence`) held against
gssr_tpu's own builder, benchmarks/convergence.py, on the CPU: the copied
make_structured_scene and orbit_cameras equal it bit for bit (means,
colours, scales; every camera matrix), a GT view rendered by the port's
plain path equals gssr_tpu's Pallas rasterize (interpret mode) within the
forward tolerance (atol 1e-5, rtol 1e-4) at 96 x 64 on a scene thinned
8-fold, and the written COLMAP scene carries the builder's sparse init
bit for bit."""
import math
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

FWD = dict(atol=1e-5, rtol=1e-4)
W, H, SUB = 96, 64, 8


def _reference():
    from benchmarks import convergence
    return convergence


def test_the_structured_scene_equals_gssr_tpus():
    ref = _reference().make_structured_scene(np.random.default_rng(0))
    mine = chip_smoke.make_structured_scene(np.random.default_rng(0))
    for a, b, what in zip(mine, ref, ("means", "colors", "scales")):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    assert len(mine[0]) == 29_500


def test_the_orbit_cameras_equal_gssr_tpus():
    ref = _reference().orbit_cameras(chip_smoke.CONV_CAMS,
                                     chip_smoke.CONV_WIDTH,
                                     chip_smoke.CONV_HEIGHT)
    mine = chip_smoke.orbit_cameras(chip_smoke.CONV_CAMS,
                                    chip_smoke.CONV_WIDTH,
                                    chip_smoke.CONV_HEIGHT)
    assert len(mine) == len(ref) == 54
    for a, b in zip(mine, ref):
        assert (a.uid, a.image_name, a.width, a.height) == \
            (b.uid, b.image_name, b.width, b.height)
        assert (a.fovx, a.fovy, a.fx, a.fy, a.cx, a.cy) == \
            (b.fovx, b.fovy, b.fx, b.fy, b.cx, b.cy)
        for k in ("R", "T", "w2c", "full_proj", "campos"):
            x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("view", [0, 31])
def test_a_gt_view_equals_gssr_tpus_pallas_render(view):
    import jax.numpy as jnp
    import torch

    from gssr_tpu.ops.rasterize import rasterize
    means, cols, scales = chip_smoke.make_structured_scene(
        np.random.default_rng(0))
    means, cols = means[::SUB], cols[::SUB]
    scales = scales[::SUB] * math.sqrt(SUB)
    cam_t = chip_smoke.orbit_cameras(chip_smoke.CONV_CAMS, W, H)[view]
    cam_j = _reference().orbit_cameras(chip_smoke.CONV_CAMS, W, H)[view]
    g = chip_smoke.structured_gaussians(means, cols, scales,
                                        torch.device("cpu"))
    mine = chip_smoke.render_structured(g, cam_t, W, H, torch.device("cpu"))
    n = len(means)
    want = np.asarray(rasterize(
        jnp.asarray(means, jnp.float32),
        jnp.asarray(np.stack([scales] * 3, -1), jnp.float32),
        jnp.tile(jnp.asarray([[1.0, 0, 0, 0]], jnp.float32), (n, 1)),
        jnp.full((n,), 0.92, jnp.float32), cam_j.arrays(), W, H,
        jnp.zeros(3, jnp.float32),
        colors_precomp=jnp.asarray(cols, jnp.float32), backend="pallas",
        instance_cap=1 << 16).image)
    assert mine.shape == want.shape == (H, W, 3)
    assert want.max() > 0.5 and (want == 0).mean() < 0.5   # the scene shows
    np.testing.assert_allclose(mine, want, **FWD)


def test_the_written_scene_carries_the_builders_init(tmp_path):
    """build_structured_scene at a small size: the images and cameras
    read back through the port's dataset, and the sparse init equal to
    benchmarks/convergence.py::build_scene_dir's draws, bit for bit."""
    import torch

    from gssr_tpu_torch.dataio.dataset import read_colmap_scene
    n_cams = 3
    n = chip_smoke.build_structured_scene(str(tmp_path), torch.device("cpu"),
                                          width=48, height=32,
                                          n_cams=n_cams, gt_sub=SUB)
    rng = np.random.default_rng(0)
    means, cols, _ = _reference().make_structured_scene(rng)
    means, cols = means[::SUB], cols[::SUB]
    assert n == len(means)
    sel = rng.choice(n, size=max(n // 12, 512), replace=False)
    pts = means[sel] + rng.normal(0, 0.02, (len(sel), 3))
    scene = read_colmap_scene(str(tmp_path))
    np.testing.assert_array_equal(scene.point_cloud.points, pts)
    np.testing.assert_array_equal(
        scene.point_cloud.colors,
        (cols[sel] * 255).astype(np.uint8).astype(np.float64) / 255.0)
    cams = sorted(scene.train_cameras, key=lambda c: c.image_name)
    ref = _reference().orbit_cameras(n_cams, 48, 32)
    assert [c.image_name for c in cams] == [c.image_name for c in ref]
    for a, b in zip(cams, ref):
        np.testing.assert_allclose(a.w2c, b.w2c, atol=1e-12)
        assert np.asarray(a.image).shape == (32, 48, 3)
