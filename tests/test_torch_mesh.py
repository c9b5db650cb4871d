"""The port's mesh path against gssr_tpu's: TSDF fusion of one view, the
numpy marching tetrahedra, cluster clean-up and mesh scores, the bounded
and unbounded extractors on the same captured maps, and the two CLIs end
to end on the CPU.

The captured maps are the exact depth of a unit sphere seen by ring
cameras, so the fused meshes approximate that sphere; both packages'
meshes are scored against one reference sphere mesh.
"""
import glob
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 32


def _ring(n=6, radius=3.0):
    from synthetic import ring_cameras
    return ring_cameras(n, radius=radius, width=W, height=H)


def _sphere_maps(cam):
    """Camera-space depth, colour and alpha of a unit sphere at the
    origin, per pixel centre; zero depth and alpha where the ray misses."""
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    d_cam = np.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                      np.ones_like(xs)], -1)
    R = cam.w2c[:3, :3]
    o = np.asarray(cam.campos, np.float64)
    d = d_cam @ R                              # world directions, z = 1
    b = (d * o).sum(-1)
    a = (d * d).sum(-1)
    disc = b * b - a * ((o * o).sum() - 1.0)
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / a, 0.0)
    p = o + t[..., None] * d
    rgb = np.clip(0.5 + 0.5 * p, 0, 1) * hit[..., None]
    f32 = lambda x: np.asarray(x, np.float32)              # noqa: E731
    return f32(t), f32(rgb), f32(hit)


def _sphere_mesh():
    from gssr_tpu_torch.utils.mtet import marching_tetrahedra
    n = 41
    g = np.linspace(-1.5, 1.5, n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - 1.0,
                               spacing=(g[1] - g[0],) * 3,
                               origin=(-1.5,) * 3)


def test_integrate_matches():
    from gssr_tpu.utils import tsdf as jt
    from gssr_tpu_torch.utils import tsdf as tt
    cam = _ring()[1]
    depth, rgb, alpha = _sphere_maps(cam)
    dims, vox, trunc = (20, 18, 16), 0.14, 0.3
    origin = np.array([-1.4, -1.2, -1.1], np.float32)
    jv = jt.make_volume(origin, dims, vox, trunc)
    tv = tt.make_volume(origin, dims, vox, trunc)
    for k in range(2):          # the second view averages into the first
        scale = np.float32(1.0 + 0.05 * k)
        args = (depth * scale, rgb, cam.w2c.astype(np.float32))
        intr = [np.float32(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy)]
        jv = jt.integrate(jv, *map(jnp.asarray, args), *intr,
                          depth_trunc=4.5, alpha=jnp.asarray(alpha))
        tv = tt.integrate(tv, *map(torch.from_numpy, args),
                          *map(torch.tensor, intr), depth_trunc=4.5,
                          alpha=torch.from_numpy(alpha))
    for f in ("tsdf", "weight", "color"):
        np.testing.assert_allclose(getattr(tv, f).numpy(),
                                   np.asarray(getattr(jv, f)), atol=1e-5,
                                   err_msg=f)
    assert float(tv.weight.max()) == 2.0 and float(tv.tsdf.min()) < 0
    jm, tm = jt.extract_mesh(jv), tt.extract_mesh(tv)
    assert len(tm[1]) > 0
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(b, a, atol=1e-4)


def test_mtet_and_mesh_eval_are_gssr_tpus():
    from gssr_tpu.utils import mesh_eval as je
    from gssr_tpu.utils import mtet as jm
    from gssr_tpu_torch.utils import mesh_eval as te
    from gssr_tpu_torch.utils import mtet as tm
    rng = np.random.default_rng(4)
    field = rng.normal(size=(14, 12, 10))
    mask = rng.uniform(size=field.shape) > 0.05
    kw = dict(level=0.1, spacing=(0.5, 0.25, 1.0), origin=(1.0, -2.0, 0.5),
              mask=mask)
    for fn in ("marching_tetrahedra", "marching_tetrahedra_blocked"):
        extra = dict(block=5) if fn.endswith("blocked") else {}
        a = getattr(jm, fn)(field, **kw, **extra)
        b = getattr(tm, fn)(field, **kw, **extra)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x, err_msg=fn)
    v, f = tm.marching_tetrahedra(field, level=0.1)
    attrs = rng.uniform(size=(len(v), 3))
    for x, y in zip(jm.keep_largest_clusters(v, f, 2, vert_attrs=attrs),
                    tm.keep_largest_clusters(v, f, 2, vert_attrs=attrs)):
        np.testing.assert_array_equal(y, x)
    gv, gf = _sphere_mesh()
    kw = dict(n_points=5000, taus=(0.05, 0.2))
    assert te.mesh_metrics(v * 0.1, f, gv, gf, **kw) == \
        je.mesh_metrics(v * 0.1, f, gv, gf, **kw)


def test_contraction_matches_and_inverts():
    from gssr_tpu.utils import tsdf as jt
    from gssr_tpu_torch.utils import tsdf as tt
    x = np.random.default_rng(2).normal(0, 3, (500, 3)).astype(np.float32)
    center = np.array([0.3, -0.2, 0.1], np.float32)
    y_j = np.asarray(jt.contract(jnp.asarray(x), jnp.asarray(center), 1.5))
    y_t = tt.contract(torch.from_numpy(x), torch.from_numpy(center), 1.5)
    np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-6, rtol=1e-6)
    assert float(y_t.norm(dim=-1).max()) < 2.0
    x_t = tt.uncontract(y_t, torch.from_numpy(center), 1.5)
    np.testing.assert_allclose(
        x_t.numpy(), np.asarray(jt.uncontract(jnp.asarray(y_j),
                                              jnp.asarray(center), 1.5)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x_t.numpy(), x, atol=1e-3, rtol=1e-3)


def _extractors():
    """gssr_tpu's and the port's extractor holding the same captured
    maps of the sphere."""
    from gssr_tpu.utils.mesh_extract import GaussianExtractor as JX
    from gssr_tpu_torch.utils.mesh_extract import GaussianExtractor as TX
    jx = JX(None, None)
    tx = TX(SimpleNamespace(device=torch.device("cpu")), None)
    cams = _ring()
    for ex in (jx, tx):
        ex.cameras = cams
        for c in cams:
            depth, rgb, alpha = _sphere_maps(c)
            ex.depthmaps.append(depth)
            ex.rgbmaps.append(rgb)
            ex.alphamaps.append(alpha)
    return jx, tx


@pytest.mark.parametrize("kind", ["bounded", "unbounded"])
def test_extracted_meshes_score_as_gssr_tpus(kind):
    from gssr_tpu_torch.utils.mesh_eval import mesh_metrics
    jx, tx = _extractors()
    if kind == "bounded":
        kw = dict(voxel_size=0.06, sdf_trunc=0.2, depth_trunc=4.0)
        jmesh, tmesh = jx.extract_mesh_bounded(**kw), \
            tx.extract_mesh_bounded(**kw)
    else:
        jmesh, tmesh = jx.extract_mesh_unbounded(48), \
            tx.extract_mesh_unbounded(48)
    assert len(tmesh[1]) > 100
    assert abs(len(tmesh[1]) - len(jmesh[1])) <= 0.01 * len(jmesh[1])
    gv, gf = _sphere_mesh()
    kw = dict(n_points=20000, taus=(0.02, 0.05))
    mj = mesh_metrics(jmesh[0], jmesh[1], gv, gf, **kw)
    mt = mesh_metrics(tmesh[0], tmesh[1], gv, gf, **kw)
    # the ring sees the sphere from its equator only: its caps go unseen
    assert mt["f1@0.05"] > 0.5 and mt["precision@0.05"] > 0.7, mt
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(tmesh[2].mean(0), np.asarray(jmesh[2]).mean(0),
                               atol=1e-3)


def test_cli_trains_2dgs_and_extracts_a_mesh_on_the_cpu(tmp_path):
    from synthetic import write_synthetic_colmap_scene

    from gssr_tpu.utils.mesh_extract import read_mesh_ply
    scene = tmp_path / "scene"
    write_synthetic_colmap_scene(str(scene), n_cams=6, n_pts=96, width=W,
                                 height=H)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = lambda *args: subprocess.run(                     # noqa: E731
        [sys.executable, "-m", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    p = run("gssr_tpu_torch.train", "2dgs", "--source-path", str(scene),
            "--output-path", str(tmp_path / "out"), "--machine.device", "cpu",
            "--trainer.iterations", "12", "--trainer.test-iterations", "12",
            "--trainer.save-iterations", "12",
            "--scene.gaussians.capacity", "512")
    assert p.returncode == 0, p.stdout + p.stderr
    cfg = glob.glob(str(tmp_path / "out" / "**" / "config.yml"),
                    recursive=True)
    assert len(cfg) == 1
    p = run("gssr_tpu_torch.extract_mesh", "--load-config", cfg[0],
            "--voxel-size", "0.08", "--sdf-trunc", "0.3",
            "--depth-trunc", "8.0", "--num-cluster", "0")
    assert p.returncode == 0, p.stdout + p.stderr
    mesh = glob.glob(str(tmp_path / "out" / "**" / "fused_mesh.ply"),
                     recursive=True)
    assert len(mesh) == 1
    renders = os.path.join(os.path.dirname(mesh[0]), "renders")
    assert len(os.listdir(renders)) == 6
    verts, faces = read_mesh_ply(mesh[0])
    assert len(verts) > 0 and len(faces) > 0
    assert np.isfinite(verts).all() and faces.max() < len(verts)
