"""The slice as a whole: gssr_tpu_torch trains vanilla 3DGS in step with
gssr_tpu (its Pallas blend in interpret mode) from one carried-across
state, and its CLI trains on the CPU and writes files gssr_tpu reads."""
import dataclasses
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


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("scene")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


def _configure(config, scene_dir, out_dir):
    config.source_path = scene_dir
    config.output_path = out_dir
    config.scene.gaussians = dataclasses.replace(
        config.scene.gaussians, capacity=256, oneup_sh_interval=5,
        densify_from_iter=DENSIFY_AT - 1, densification_interval=DENSIFY_AT,
        densify_grad_threshold=2e-5)
    return config


def test_training_tracks_gssr_tpu(scene_dir, tmp_path):
    from gssr_tpu.configs.methods import build_scene as j_build
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu_torch.configs.methods import build_scene as t_build
    from gssr_tpu_torch.configs.methods import get_method_config as t_config
    from gssr_tpu_torch.models.convert import state_from_numpy, state_to_numpy

    jc = _configure(j_config("3dgs"), scene_dir, str(tmp_path / "j"))
    jc.scene.instance_cap = 4096
    jc.scene.backend = "pallas"
    tc = _configure(t_config("3dgs"), scene_dir, str(tmp_path / "t"))
    js_, ts_ = j_build(jc), t_build(tc, "cpu")
    js = js_.state
    ts = state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)],
                          "cpu")
    cap = ts.active.shape[0]

    for step in range(1, STEPS + 1):
        jcam, tcam = js_.dataloader.next_train(), ts_.dataloader.next_train()
        assert jcam.image_name == tcam.image_name
        js, jm = js_.train_step(js, jcam, step)
        ts, tm = ts_.train_step(ts, tcam, step)
        assert not bool(jm["overflow"]) and not bool(tm["overflow"])
        assert int(tm["num_rendered"]) == int(jm["num_rendered"]), step
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3, err_msg=f"step {step}")
        # the reference splits its key and draws the split noise from it
        _, key = jax.random.split(js_.key)
        noise = np.array(jax.random.normal(key, (2, cap, 3)))
        n_before = int(ts.n_active)
        js = js_.densify(js, step)
        ts = ts_.densify(ts, step, noise=torch.from_numpy(noise))
        if step == DENSIFY_AT:
            assert int(ts.n_active) != n_before          # densify ran
        assert int(ts.n_active) == int(js.n_active), step
        np.testing.assert_array_equal(ts.active.numpy(),
                                      np.asarray(js.active))

    assert ts_.gaussians.active_sh_degree(STEPS) == 2
    # every leaf to its own scale, so that the small ones (Adam's moments,
    # the densify stats) are held as tightly as the parameters
    for i, (a, b) in enumerate(zip(jax.tree.leaves(js),
                                   state_to_numpy(ts))):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"leaf {i}")


def test_cli_trains_on_the_cpu_and_gssr_tpu_reads_its_files(scene_dir,
                                                            tmp_path):
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "gssr_tpu_torch.train", "3dgs",
         "--source-path", scene_dir, "--output-path", str(out),
         "--machine.device", "cpu", "--timestamp", "run",
         "--trainer.iterations", "6", "--trainer.test-iterations", "6",
         "--trainer.save-iterations", "6",
         "--trainer.checkpoint-iterations", "6",
         "--scene.gaussians.capacity", "256"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[eval 6]" in proc.stdout
    base = out / os.path.basename(scene_dir) / "3dgs" / "run"
    assert (base / "DONE").exists()

    from gssr_tpu.models.vanilla import VanillaGaussianConfig, VanillaGaussians
    from gssr_tpu_torch.configs.base import load_config_yaml
    g = VanillaGaussians(VanillaGaussianConfig(capacity=256))
    st = g.load_ply(str(base / "point_cloud/iteration_6/point_cloud.ply"))
    ckpt = np.load(next((base / "chkpnt").glob("ckpt_*.npz")))
    leaves = [ckpt[f"leaf_{i}"] for i in range(len(jax.tree.leaves(st)))]
    active = leaves[22]
    assert int(st.n_active) == int(active.sum()) == int(leaves[23]) > 0
    for i, k in enumerate(("xyz", "f_dc", "f_rest", "scaling", "rotation",
                           "opacity")):
        np.testing.assert_array_equal(
            np.asarray(getattr(st.params, k))[:int(st.n_active)],
            leaves[i][active], err_msg=k)
    cfg = load_config_yaml(base / "config.yml")
    assert cfg.machine.device == "cpu" and cfg.scene.gaussians.capacity == 256


def test_a_gssr_tpu_checkpoint_resumes_in_the_port(scene_dir, tmp_path):
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu.engine.trainer import Trainer as JTrainer
    from gssr_tpu_torch.configs.methods import get_method_config as t_config
    from gssr_tpu_torch.engine.trainer import Trainer as TTrainer
    from gssr_tpu_torch.models.convert import state_to_numpy

    jt = JTrainer(_configure(j_config("3dgs"), scene_dir, str(tmp_path / "j")))
    jt.setup()
    for _ in range(3):
        jt.scene.dataloader.next_train()
    jt.save_checkpoint(jt.scene.state, 3)

    tc = _configure(t_config("3dgs"), scene_dir, str(tmp_path / "t"))
    tc.machine.device = "cpu"
    tc.trainer.load_ckpt_dir = str(jt.ckpt_dir)
    tt = TTrainer(tc)
    tt.setup()
    assert tt.start_step == 3
    for i, (a, b) in enumerate(zip(jax.tree.leaves(jt.scene.state),
                                   state_to_numpy(tt.scene.state))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"leaf {i}")
    # the sampler resumes where the reference stopped
    assert tt.scene.dataloader.next_train().image_name == \
        jt.scene.dataloader.next_train().image_name


def test_the_entry_point_refuses_to_run_without_the_card(monkeypatch):
    from gssr_tpu_torch.configs.base import MachineConfig
    from gssr_tpu_torch.configs.methods import get_method_config
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--machine.device cpu"):
        MachineConfig().torch_device()
    assert MachineConfig(device="cpu").torch_device().type == "cpu"
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_method_config("scaffold-pgsr")
