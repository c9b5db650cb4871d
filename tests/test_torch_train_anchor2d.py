"""The anchor surfel methods in the port track gssr_tpu (its Pallas surfel
kernels in interpret mode) step for step from one carried-across state:
`scaffold-2dgs` and `octree-2dgs` (three levels) over steps 7001-7010,
where the 2DGS normal and distortion regularisers are live (lambda_dist
100), with adjust_anchor after steps 7004 and 7008 growing anchors
(tests/test_torch_train_octree.py::track_gssr_tpu states the tolerances).
Also: the CLI trains octree-2dgs on the CPU and extract_mesh meshes it,
and extract_mesh reads a gssr_tpu octree-2dgs run.
"""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_octree import configure, track_gssr_tpu  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("scene_anchor2d")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


@pytest.mark.parametrize("method,depth_ratio", [("scaffold-2dgs", 0.0),
                                                ("octree-2dgs", 0.5)])
def test_anchor_surfel_training_tracks_gssr_tpu(scene_dir, tmp_path, method,
                                                depth_ratio):
    history, grown, _, dropped, _ = track_gssr_tpu(
        method, scene_dir, str(tmp_path), first_step=7001,
        lambda_dist=100.0, depth_ratio=depth_ratio)
    assert grown > 0, grown
    # both regularisers are live (a render with no neural gaussian has
    # zero distortion)
    assert all(h["normal_loss"] > 0 for h in history), history
    assert max(h["dist_loss"] for h in history) > 0, history
    if method.startswith("octree"):
        assert dropped > 0, "the LOD mask dropped no active anchor"


def test_cli_trains_octree_2dgs_and_extracts_a_mesh_on_the_cpu(scene_dir,
                                                               tmp_path):
    from gssr_tpu.utils.mesh_extract import read_mesh_ply
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = lambda *args: subprocess.run(                     # noqa: E731
        [sys.executable, "-m", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    p = run("gssr_tpu_torch.train", "octree-2dgs", "--source-path",
            scene_dir, "--output-path", str(tmp_path / "out"),
            "--machine.device", "cpu", "--trainer.iterations", "6",
            "--trainer.test-iterations", "6",
            "--trainer.save-iterations", "6",
            "--scene.gaussians.levels", "3")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[eval 6]" in p.stdout
    cfg = glob.glob(str(tmp_path / "out" / "**" / "config.yml"),
                    recursive=True)
    assert len(cfg) == 1
    saved = os.path.join(os.path.dirname(cfg[0]), "point_cloud",
                         "iteration_6")
    for f in ("point_cloud.ply", "point_cloud_mlp.npz", "checkpoints.pth"):
        assert os.path.getsize(os.path.join(saved, f)) > 0, f
    p = run("gssr_tpu_torch.extract_mesh", "--load-config", cfg[0],
            "--voxel-size", "0.08", "--sdf-trunc", "0.3",
            "--depth-trunc", "8.0", "--num-cluster", "0")
    assert p.returncode == 0, p.stdout + p.stderr
    mesh = glob.glob(str(tmp_path / "out" / "**" / "fused_mesh.ply"),
                     recursive=True)
    assert len(mesh) == 1
    verts, faces = read_mesh_ply(mesh[0])
    assert len(verts) > 0 and len(faces) > 0
    assert np.isfinite(verts).all() and faces.max() < len(verts)


def test_extract_mesh_reads_a_gssr_tpu_octree_2dgs_run(scene_dir, tmp_path,
                                                       capsys):
    """A run directory that gssr_tpu wrote (its config.yml, the PLY with
    the octree columns and the _mlp.npz of step 3): the port drops the
    config's gssr_tpu-only fields, restores the levels, the voxel size and
    the MLP, and renders every camera."""
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu.engine.trainer import Trainer as JTrainer
    from gssr_tpu_torch import extract_mesh

    jc = configure(j_config("octree-2dgs"), scene_dir, str(tmp_path / "j"))
    jc.timestamp = "run"
    jt = JTrainer(jc)
    jt.setup()
    jt.save_gaussians(jt.scene.state, 3)
    jc.save_config()
    cfg = jc.get_base_dir() / "config.yml"
    config, scene, _, it = extract_mesh.eval_setup(str(cfg), device="cpu")
    notes = capsys.readouterr().out
    assert "dropped gssr_tpu field Octree2DGSSceneConfig.instance_cap" \
        in notes
    assert it == 3
    jg, tg = jt.scene.gaussians, scene.gaussians
    assert tg.voxel_size == np.float32(jg.voxel_size)
    assert tg.levels == jg.levels == 3
    n = int(jt.scene.state.n_active)
    assert int(scene.state.n_active) == n
    np.testing.assert_array_equal(scene.state.level.numpy()[:n],
                                  np.asarray(jt.scene.state.level)[:n])
    np.testing.assert_array_equal(scene.state.mlp["op_w1"].numpy(),
                                  np.asarray(jt.scene.state.mlp.op_w1))
    res = extract_mesh.main(["--load-config", str(cfg), "--machine.device",
                             "cpu", "--skip-mesh"])
    renders = sorted((cfg.parent / "mesh_3" / "renders").glob("*.png"))
    assert len(renders) == len(jt.scene.dataloader.train_cameras) > 0
    assert res["seconds"]["render"] > 0


@pytest.mark.parametrize("route", ["vanilla", "surfel", "planar"])
def test_a_render_of_no_gaussian_is_the_background(route):
    """An anchor render with no visible anchor decodes no gaussian: each
    rasterizer returns the background, nothing rendered, and empty
    gradients."""
    import math

    import torch

    from gssr_tpu_torch.cameras import Camera
    from gssr_tpu_torch.ops.rasterize import rasterize
    from gssr_tpu_torch.ops.rasterize2d import rasterize_2d
    from gssr_tpu_torch.ops.rasterize_pgsr import rasterize_pgsr
    cam = Camera(uid=0, colmap_id=1, image_name="c", R=np.eye(3),
                 T=np.array([0.0, 0.0, 4.0]), fovx=math.radians(60),
                 fovy=math.radians(60), width=32, height=32).arrays("cpu")
    fn, dims, kw = {"vanilla": (rasterize, 3, {}),
                    "surfel": (rasterize_2d, 2, {}),
                    "planar": (rasterize_pgsr, 3,
                               {"forward_observe": False})}[route]
    inputs = [torch.zeros(s, requires_grad=True)
              for s in ((0, 3), (0, dims), (0, 4), (0,), (0, 3), (0, 2))]
    xyz, scales, rots, opacity, color, m2d = inputs
    bg = torch.tensor([0.1, 0.2, 0.3])
    out = fn(xyz, scales, rots, opacity, cam, 32, 32, bg,
             colors_precomp=color, mean2d_offset=m2d, **kw)
    assert int(out.num_rendered) == 0
    torch.testing.assert_close(out.image, bg.expand(32, 32, 3))
    grads = torch.autograd.grad(out.image.mean(), inputs, allow_unused=True)
    for x, g in zip(inputs, grads):
        assert g is None or g.shape == x.shape
