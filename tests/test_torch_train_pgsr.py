"""PGSR training in the port tracks gssr_tpu (its Pallas planar kernels in
interpret mode) step for step from one carried-across anisotropic state:
the `pgsr` preset from step 1 through a densify (single-camera steps), and
steps 7001-7010 (two-camera steps: normal, geo and NCC losses) with a
densify at step 7008 that reaches the abs-split channel and the size
prune. With 4 cameras and num_multi_view = 5 every camera lists itself
among its neighbours, as in gssr_tpu, so some steps pair a camera with
itself, where every pixel reprojects onto itself.

Losses at rtol 1e-3, the neighbour drawn at every step and the active
masks exactly, the final state and extra statistics leaf by leaf to 2e-4
of each leaf's largest value. Also: a gssr_tpu pgsr checkpoint resumes in
the port, and the CLI trains pgsr and meshes it on the CPU.
"""
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10
DENSIFY_AT = 8
LOSSES = ("loss", "normal_loss", "geo_loss", "ncc_loss")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("scene_pgsr")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


def _configure(config, scene_dir, out_dir):
    config.source_path = scene_dir
    config.output_path = out_dir
    config.scene.gaussians = dataclasses.replace(
        config.scene.gaussians, capacity=256, oneup_sh_interval=5,
        densify_from_iter=DENSIFY_AT - 1, densification_interval=DENSIFY_AT,
        percent_dense=0.15, densify_grad_threshold=0.0037,
        densify_abs_grad_threshold=0.01, abs_split_radii2D_threshold=4.0)
    return config


def _anisotropic(state, seed=0):
    """The initial state with random rotations and three unequal scales:
    the preset's gaussians are isotropic and unrotated, so the smallest
    axis that picks each plane normal would be a tie of rounding noise."""
    rng = np.random.default_rng(seed)
    p = state.params
    cap = p.rotation.shape[0]
    rot = rng.normal(size=(cap, 4)).astype(np.float32)
    scaling = np.asarray(p.scaling) + rng.uniform(
        -0.7, 0.7, (cap, 3)).astype(np.float32)
    return state._replace(params=p._replace(rotation=rot, scaling=scaling))


def _abs_split_candidates(scene, state):
    """Gaussians that only the abs-gradient channel would split."""
    c = scene.config.gaussians
    grads = state.stats["grad_accum"] / state.stats["denom"].clamp(min=1e-12)
    ex = scene.extra_stats
    g_abs = ex["grad_accum_abs"] / ex["denom_abs"].clamp(min=1e-12)
    big = scene.gaussians.get_scaling(state.params).amax(-1) \
        > c.percent_dense * scene.cameras_extent
    return int((state.active & big & (grads < c.densify_grad_threshold)
                & (state.stats["max_radii2d"] > c.abs_split_radii2D_threshold)
                & (g_abs >= c.densify_abs_grad_threshold)).sum())


def _record_picks(scene):
    picks, choose = [], scene.key_host_choice

    def record(ids):
        picks.append(choose(ids))
        return picks[-1]
    scene.key_host_choice = record
    return picks


@pytest.mark.parametrize("first_step", [1, 7001],
                         ids=["preset", "multi-view"])
def test_pgsr_training_tracks_gssr_tpu(scene_dir, tmp_path, first_step):
    from gssr_tpu.configs.methods import build_scene as j_build
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu_torch.configs.methods import build_scene as t_build
    from gssr_tpu_torch.configs.methods import get_method_config as t_config
    from gssr_tpu_torch.models.convert import state_from_numpy, state_to_numpy

    jc = _configure(j_config("pgsr"), scene_dir, str(tmp_path / "j"))
    jc.scene.instance_cap = 4096
    jc.scene.backend = "pallas"
    tc = _configure(t_config("pgsr"), scene_dir, str(tmp_path / "t"))
    js_, ts_ = j_build(jc), t_build(tc, "cpu")
    assert [c.near_ids for c in ts_.dataloader.train_cameras] == \
        [c.near_ids for c in js_.dataloader.train_cameras]
    js = _anisotropic(js_.state)
    ts = state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)],
                          "cpu")
    cap = ts.active.shape[0]
    picks_j, picks_t = _record_picks(js_), _record_picks(ts_)

    densified = self_pair = False
    geo = []
    for step in range(first_step, first_step + STEPS):
        jcam, tcam = js_.dataloader.next_train(), ts_.dataloader.next_train()
        assert jcam.image_name == tcam.image_name
        js, jm = js_.train_step(js, jcam, step)
        ts, tm = ts_.train_step(ts, tcam, step)
        assert picks_t == picks_j, step
        assert int(tm["num_rendered"]) == int(jm["num_rendered"]), step
        assert set(tm) == set(jm), step
        for k in LOSSES:
            if k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-3, atol=1e-7,
                                           err_msg=f"{k} step {step}")
        assert all(torch.isfinite(v).all() for v in ts.params.values())
        if "geo_loss" in tm:
            geo.append(float(tm["geo_loss"]))
            me = ts_.dataloader.train_cameras.index(tcam)
            self_pair |= picks_t[-1] == me
        _, key = jax.random.split(js_.key)
        noise = np.stack([np.asarray(jax.random.normal(k, (cap, 3)))
                          for k in jax.random.split(key, 3)])
        n_before = int(ts.n_active)
        if step % DENSIFY_AT == 0 and step > tc.scene.multi_view_from:
            assert _abs_split_candidates(ts_, ts) > 0
        js = js_.densify(js, step)
        ts = ts_.densify(ts, step, noise=torch.from_numpy(noise))
        densified |= int(ts.n_active) != n_before
        assert int(ts.n_active) == int(js.n_active), step
        np.testing.assert_array_equal(ts.active.numpy(),
                                      np.asarray(js.active))
    assert densified
    if first_step > tc.scene.multi_view_from:
        assert len(geo) == STEPS and max(geo) > 0 and self_pair
    else:
        assert not geo and not picks_t
    pairs = [(np.asarray(a), b) for a, b in zip(jax.tree.leaves(js),
                                                state_to_numpy(ts))]
    pairs += [(np.asarray(js_.extra_stats[k]), ts_.extra_stats[k].numpy())
              for k in ts_.extra_stats]
    for i, (a, b) in enumerate(pairs):
        a, b = a.astype(np.float32), b.astype(np.float32)
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"leaf {i}")


def test_a_gssr_tpu_pgsr_checkpoint_resumes_in_the_port(scene_dir,
                                                        tmp_path):
    """The state, the extra statistics, the neighbour draws and the
    sampler resume where gssr_tpu stopped; models/convert.py carries the
    PGSR state itself."""
    import jax.numpy as jnp

    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu.engine.trainer import Trainer as JTrainer
    from gssr_tpu_torch.configs.methods import get_method_config as t_config
    from gssr_tpu_torch.engine.trainer import Trainer as TTrainer
    from gssr_tpu_torch.models.convert import state_to_numpy

    jt = JTrainer(_configure(j_config("pgsr"), scene_dir,
                             str(tmp_path / "j")))
    jt.setup()
    rng = np.random.default_rng(0)
    js = jt.scene
    js.extra_stats = {k: jnp.asarray(rng.uniform(0, 1, v.shape), jnp.float32)
                      for k, v in js.extra_stats.items()}
    for _ in range(3):
        js.dataloader.next_train()
        js.key_host_choice(js.dataloader.train_cameras[0].near_ids)
    jt.save_checkpoint(js.state, 3)

    tc = _configure(t_config("pgsr"), scene_dir, str(tmp_path / "t"))
    tc.machine.device = "cpu"
    tc.trainer.load_ckpt_dir = str(jt.ckpt_dir)
    tt = TTrainer(tc)
    tt.setup()
    ts = tt.scene
    assert tt.start_step == 3
    for i, (a, b) in enumerate(zip(jax.tree.leaves(js.state),
                                   state_to_numpy(ts.state))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"leaf {i}")
    for k, v in js.extra_stats.items():
        np.testing.assert_array_equal(ts.extra_stats[k].numpy(),
                                      np.asarray(v), err_msg=k)
    ids = js.dataloader.train_cameras[1].near_ids
    assert ts.key_host_choice(ids) == js.key_host_choice(ids)
    assert ts.dataloader.next_train().image_name == \
        js.dataloader.next_train().image_name


@pytest.fixture(scope="module")
def gssr_tpu_run(scene_dir, tmp_path_factory):
    """A pgsr run directory that gssr_tpu wrote: its config.yml (two
    iterations) and the PLY of step 3. Returns (config path, number of
    train cameras)."""
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu.engine.trainer import Trainer as JTrainer

    jc = _configure(j_config("pgsr"), scene_dir,
                    str(tmp_path_factory.mktemp("j_run")))
    jc.timestamp = "run"
    jc.trainer.iterations = 2
    jc.trainer.test_iterations = [2]
    jc.trainer.save_iterations = [2]
    jc.trainer.log_interval = 1
    jt = JTrainer(jc)
    jt.setup()
    jt.save_gaussians(jt.scene.state, 3)
    jc.save_config()
    return (jc.get_base_dir() / "config.yml",
            len(jt.scene.dataloader.train_cameras))


def test_extract_mesh_reads_a_gssr_tpu_pgsr_run(gssr_tpu_run):
    """`extract_mesh --load-config` on a run directory that gssr_tpu wrote
    (its config.yml and PLY): the port drops the config's gssr_tpu-only
    fields and renders every camera."""
    from gssr_tpu_torch import extract_mesh

    cfg, n_cams = gssr_tpu_run
    res = extract_mesh.main(["--load-config", str(cfg), "--machine.device",
                             "cpu", "--skip-mesh"])
    renders = sorted((cfg.parent / "mesh_3" / "renders").glob("*.png"))
    assert len(renders) == n_cams > 0
    assert res["seconds"]["render"] > 0


def test_train_reads_a_gssr_tpu_pgsr_run(gssr_tpu_run, capsys):
    """`train --trainer.load-config` on a gssr_tpu run's config.yml re-runs
    it in the port, on the CPU this command names: its two steps train
    pgsr in a new run directory beside the old one, with finite losses and
    the PLY of step 2."""
    from gssr_tpu_torch import train
    from gssr_tpu_torch.configs.cli import parse_config

    cfg, _ = gssr_tpu_run
    trainer = train.main(parse_config(
        ["pgsr", "--trainer.load-config", str(cfg), "--machine.device",
         "cpu"]))
    notes = capsys.readouterr().out
    assert "dropped gssr_tpu field MachineConfig.num_devices" in notes
    config = trainer.config
    assert config.machine.device == "cpu"
    assert config.method_name == "pgsr"
    run_dir = config.get_base_dir()
    assert run_dir != cfg.parent and run_dir.parent == cfg.parent.parent
    assert (run_dir / "DONE").read_text() == "iterations=2\n"
    assert (run_dir / "point_cloud" / "iteration_2"
            / "point_cloud.ply").exists()
    losses = [loss for _, loss, *_ in trainer.history]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_cli_trains_pgsr_and_extracts_a_mesh_on_the_cpu(scene_dir, tmp_path):
    from gssr_tpu.utils.mesh_extract import read_mesh_ply
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    run = lambda *args: subprocess.run(                     # noqa: E731
        [sys.executable, "-m", *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    p = run("gssr_tpu_torch.train", "pgsr", "--source-path", scene_dir,
            "--output-path", str(tmp_path / "out"), "--machine.device", "cpu",
            "--trainer.iterations", "6", "--trainer.test-iterations", "6",
            "--trainer.save-iterations", "6",
            "--scene.multi-view-from", "3",
            "--scene.gaussians.capacity", "256")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[eval 6]" in p.stdout
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
    verts, faces = read_mesh_ply(mesh[0])
    assert len(verts) > 0 and len(faces) > 0
    assert np.isfinite(verts).all() and faces.max() < len(verts)
