"""The port's partitioned pipeline on the CPU: train_split's striping over
hosts and its DONE-marker skip (the printed lines of gssr_tpu's
train_split), split_scene -> train_split -> extract_mesh_split end to end,
and the merged volume and mesh held against gssr_tpu's fusion of the same
renders."""
import glob
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MERGE = dict(voxel_size=0.08, sdf_trunc=0.3, depth_trunc=8.0)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def test_rank_striping_and_done_skip(tmp_path, capsys):
    from synthetic import write_synthetic_colmap_scene

    from gssr_tpu_torch import train_split
    base = tmp_path / "scene"
    write_synthetic_colmap_scene(str(base / "tile_0000"), n_cams=4,
                                 n_pts=64, width=32, height=32)
    for t in ("tile_0001", "tile_0002"):
        shutil.copytree(base / "tile_0000", base / t)
    common = ["3dgs", "--source-path", str(base),
              "--output-path", str(tmp_path / "runs"),
              "--machine.device", "cpu",
              "--trainer.iterations", "4",
              "--trainer.test-iterations", "4",
              "--trainer.save-iterations", "4",
              "--scene.gaussians.capacity", "256"]
    host = lambda r: ["--machine.num-hosts", "2",          # noqa: E731
                      "--machine.host-rank", str(r)]

    # host 0 of 2 trains tiles 0 and 2 only, through the CLI
    p = subprocess.run([sys.executable, "-m", "gssr_tpu_torch.train_split",
                        *common, *host(0)], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "trained 2 tiles (skipped 0 done) on host 0/2" in p.stdout
    runs = tmp_path / "runs" / "scene"
    assert sorted(os.listdir(runs)) == ["tile_0000", "tile_0002"]
    assert len(glob.glob(str(runs / "*" / "3dgs" / "*" / "DONE"))) == 2

    # the same host again: both tiles carry DONE markers and are skipped
    assert train_split.main(common + host(0)) == \
        ([], [str(base / "tile_0000"), str(base / "tile_0002")])
    out = capsys.readouterr().out
    assert "trained 0 tiles (skipped 2 done) on host 0/2" in out
    assert f"=== skipping {base / 'tile_0000'} (done: " in out

    # host 1 picks up the remaining tile
    train_split.main(common + host(1))
    out = capsys.readouterr().out
    assert f"=== training {base / 'tile_0001'} (2/3) ===" in out
    assert "trained 1 tiles (skipped 0 done) on host 1/2" in out
    assert (runs / "tile_0001").exists()

    # --retrain true trains the done tiles again
    trained, skipped = train_split.main(common + host(0)
                                        + ["--retrain", "true"])
    assert len(trained) == 2 and not skipped
    assert "trained 2 tiles (skipped 0 done) on host 0/2" in \
        capsys.readouterr().out


def test_a_card_is_needed_without_the_cpu_flag(tmp_path, monkeypatch):
    import torch

    from gssr_tpu_torch import train_split
    (tmp_path / "tile_0000").mkdir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_split.main(["3dgs", "--source-path", str(tmp_path)])


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    """split_scene -> train_split (2dgs, 2 tiles) -> extract_mesh_split on
    the CPU, in process; returns extract_mesh_split's result."""
    from synthetic import write_synthetic_colmap_scene

    from gssr_tpu_torch import extract_mesh_split, split_scene, train_split
    root = tmp_path_factory.mktemp("split")
    scene = root / "scene"
    write_synthetic_colmap_scene(str(scene), n_cams=10, n_pts=128,
                                 width=48, height=32)
    tiles = split_scene.main(["--source-path", str(scene),
                              "--num-col", "2", "--num-row", "1",
                              "--visibility-threshold", "0.0"])
    assert [os.path.basename(t) for t in tiles] == ["tile_0000",
                                                     "tile_0001"]
    runs = root / "runs"
    trained, _ = train_split.main([
        "2dgs", "--source-path", str(scene), "--output-path", str(runs),
        "--machine.device", "cpu", "--trainer.iterations", "10",
        "--trainer.test-iterations", "10", "--trainer.save-iterations", "10",
        "--scene.gaussians.capacity", "512"])
    assert trained == tiles
    return extract_mesh_split.main([
        "--source-path", str(scene), "--runs-root", str(runs),
        "--method", "2dgs", "--num-cluster", "0",
        "--out", str(root / "merged.ply"),
        *(f"--{k.replace('_', '-')}={v}" for k, v in MERGE.items())])


def test_split_train_merge_on_the_cpu(merged):
    from gssr_tpu_torch.utils.mesh_extract import read_mesh_ply
    verts, faces = read_mesh_ply(merged["mesh_path"])
    assert len(verts) == merged["verts"] > 0
    assert len(faces) == merged["faces"] > 0
    assert np.isfinite(verts).all() and faces.max() < len(verts)
    # every camera lies in its own tile's box, so it renders in some tile
    rendered = [n for names in merged["in_box"].values() for n in names]
    assert sorted(set(rendered)) == [f"cam{i:03d}" for i in range(10)]
    assert list(merged["in_box"]) == ["tile_0000", "tile_0001"]
    assert set(merged["seconds"]) == {"render", "fusion", "mtet"}


def test_the_merge_matches_gssr_tpus_fusion(merged):
    from gssr_tpu.utils import tsdf as jt
    from gssr_tpu_torch.utils import tsdf as tt
    cams, depths, rgbs, alphas = merged["views"]
    # gssr_tpu's extract_mesh_split places its volume so
    center = np.stack([c.campos for c in cams]).mean(axis=0)
    half = MERGE["depth_trunc"] * 0.5
    dims = min(int(np.ceil(2 * half / MERGE["voxel_size"])), 768)
    vol = jt.make_volume(center - half, (dims,) * 3, MERGE["voxel_size"],
                         MERGE["sdf_trunc"])
    for cam, depth, rgb, alpha in zip(cams, depths, rgbs, alphas):
        vol = jt.integrate_jit(vol, jnp.asarray(depth), jnp.asarray(rgb),
                               jnp.asarray(cam.w2c), jnp.asarray(cam.fx),
                               jnp.asarray(cam.fy), jnp.asarray(cam.cx),
                               jnp.asarray(cam.cy),
                               depth_trunc=MERGE["depth_trunc"],
                               alpha=jnp.asarray(alpha))
    mine = merged["volume"]
    assert tuple(mine.tsdf.shape) == (dims,) * 3
    np.testing.assert_array_equal(mine.origin.numpy(),
                                  np.asarray(vol.origin))
    for f in ("tsdf", "weight", "color"):
        np.testing.assert_allclose(getattr(mine, f).numpy(),
                                   np.asarray(getattr(vol, f)), atol=1e-5,
                                   err_msg=f)
    assert float(mine.weight.max()) >= 2 and float(mine.tsdf.min()) < 0
    (jv, jf, jc), (tv, tf, tc) = jt.extract_mesh(vol), tt.extract_mesh(mine)
    assert len(tf) == merged["faces"] > 0 and len(tf) == len(jf)
    # the same mesh, up to the order of its vertices: volumes that agree
    # to ~2e-6 can weld and sort a few vertices apart
    from scipy.spatial import cKDTree
    _, perm = cKDTree(np.asarray(jv)).query(tv)
    assert len(tv) == len(jv) and len(np.unique(perm)) == len(tv)
    np.testing.assert_allclose(tv, np.asarray(jv)[perm], atol=1e-4)
    np.testing.assert_allclose(tc, np.asarray(jc)[perm], atol=1e-4)
    faces = lambda f: np.unique(np.sort(f, axis=1), axis=0)  # noqa: E731
    np.testing.assert_array_equal(faces(perm[tf]), faces(np.asarray(jf)))


@pytest.mark.parametrize("with_cv2", [True, False])
def test_a_tile_run_renders_a_fly_through(merged, with_cv2, monkeypatch):
    from gssr_tpu_torch import extract_mesh
    if not with_cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)    # import fails
    root = os.path.dirname(merged["mesh_path"])
    cfg = sorted(glob.glob(os.path.join(root, "runs", "*", "tile_0000",
                                        "2dgs", "*", "config.yml")))[-1]
    res = extract_mesh.main(["--load-config", cfg, "--render-video",
                             "--video-frames", "5", "--skip-mesh",
                             "--skip-images"])
    assert "mesh_path" not in res and res["seconds"]["video"] > 0
    mesh_dir = os.path.join(os.path.dirname(cfg), "mesh_10")
    if res["video"].endswith(".mp4"):
        assert with_cv2 and res["video"] == os.path.join(mesh_dir,
                                                         "render_traj.mp4")
        assert os.path.getsize(res["video"]) > 0
    else:
        assert res["video"] == os.path.join(mesh_dir, "render_traj_frames")
        assert len(os.listdir(res["video"])) == 5
    assert not os.path.exists(os.path.join(mesh_dir, "fused_mesh.ply"))


def _ring_scene(root, n=8, radius=4.0):
    """A COLMAP model of n cameras on a ring around the origin at heights
    0.3 cos(3a), as chip_smoke.py's scene, each tracking 64 points."""
    import math

    from gssr_tpu_torch.dataio import colmap
    rng = np.random.default_rng(0)
    images = {}
    for i in range(n):
        a = 2 * math.pi * i / n
        pos = np.array([radius * math.sin(a), 0.3 * math.cos(3 * a),
                        -radius * math.cos(a)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd])
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat_to_qvec(R_w2c), -R_w2c @ pos, 1,
            f"cam{i:03d}.png", np.zeros((64, 2)), np.arange(1, 65))
    points = {k: colmap.ColmapPoint3D(
        k, rng.uniform(-1, 1, 3), np.zeros(3, np.uint8), 0.1,
        np.arange(1, n + 1), np.zeros(n, np.int32)) for k in range(1, 65)}
    intr = {1: colmap.ColmapCamera(1, "PINHOLE", 160, 106,
                                   np.array([100.0, 100.0, 80.0, 53.0]))}
    colmap.write_model(intr, images, points, os.path.join(root, "sparse/0"))


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)])
def test_every_camera_lies_in_its_own_tiles_box(grid, tmp_path):
    """A tile's box is the extent of its cameras' centres, so cameras lie
    on its edges. gssr_tpu's extract_mesh_split tests their float32
    `campos`, which rounds out of the box for some of them: on this ring,
    split in the ground-plane frame, no tile renders those cameras. The
    port tests the float64 centre the box was computed from."""
    from gssr_tpu_torch.dataio.dataset import read_colmap_scene
    from gssr_tpu_torch.extract_mesh_split import in_box_cameras, load_box
    from gssr_tpu_torch.utils.partition import split_scene
    _ring_scene(str(tmp_path))
    tiles = split_scene(str(tmp_path), str(tmp_path / "split"),
                        num_col=grid[0], num_row=grid[1], auto_align=True,
                        copy_images=False)
    port, float32 = set(), set()
    for t in tiles:
        box = load_box(t)
        cams = read_colmap_scene(t, load_images=False).train_cameras
        port |= {c.image_name for c in in_box_cameras(cams, box)}
        mx, Mx, my, My = box
        float32 |= {c.image_name for c in cams
                    if mx <= c.campos[0] <= Mx and my <= c.campos[1] <= My}
    assert port == {f"cam{i:03d}" for i in range(8)}
    # the cameras gssr_tpu's test loses: 2 of 8 on the 2 x 1 grid, 6 on
    # the 2 x 2
    assert len(float32) == {(2, 1): 6, (2, 2): 2}[grid], sorted(float32)
