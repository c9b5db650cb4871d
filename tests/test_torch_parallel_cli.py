"""`python -m gssr_tpu_torch.train <method> --machine.parallel dp|band|gshard
--machine.num-devices 2 --machine.device cpu` end to end: the command
starts two gloo ranks itself (parallel/launch.py::spawn), they train a few
steps, and rank 0 alone writes the run (one config, one PLY, one DONE,
one log)."""
import glob
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("cli_scene")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


@pytest.mark.parametrize("method,mode", [
    ("3dgs", "dp"), ("3dgs", "band"), ("3dgs", "gshard"),
    ("octree-2dgs", "dp"), ("octree-2dgs", "band"),
    ("octree-2dgs", "gshard"), ("pgsr", "dp"), ("pgsr", "band")])
def test_cli_trains_on_two_ranks_and_rank_0_writes(scene_dir, tmp_path,
                                                   method, mode):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE",
                        "GSSR_COORDINATOR", "GSSR_NUM_PROCESSES")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    extra = {"octree-2dgs": ["--scene.gaussians.levels", "3"],
             "pgsr": ["--scene.multi-view-from", "2"]}.get(method, [])
    p = subprocess.run(
        [sys.executable, "-m", "gssr_tpu_torch.train", method,
         "--source-path", scene_dir, "--output-path", str(tmp_path / "out"),
         "--machine.device", "cpu", "--machine.parallel", mode,
         "--machine.num-devices", "2", "--trainer.iterations", str(STEPS),
         "--trainer.test-iterations", str(STEPS),
         "--trainer.save-iterations", str(STEPS),
         "--trainer.log-interval", "1", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    out = p.stdout
    assert out.count(f"multi-device: mode={mode} over 2 ranks, backend "
                     "gloo") == 1, out
    assert out.count(f"[eval {STEPS}]") == 1, out
    assert out.count("saved gaussians to") == 1, out
    runs = glob.glob(str(tmp_path / "out" / "**" / "config.yml"),
                     recursive=True)
    assert len(runs) == 1, runs
    run = os.path.dirname(runs[0])
    assert os.path.exists(os.path.join(run, "DONE"))
    ply = os.path.join(run, "point_cloud", f"iteration_{STEPS}",
                       "point_cloud.ply")
    assert os.path.getsize(ply) > 0
    from gssr_tpu_torch.configs.base import load_config_yaml
    machine = load_config_yaml(runs[0]).machine
    assert (machine.parallel, machine.num_devices) == (mode, 2)
