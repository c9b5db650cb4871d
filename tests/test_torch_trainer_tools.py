"""The port's run tooling against gssr_tpu's: the TensorBoard scalars both
trainers write over the same steps of the same scene, the profiler
window's trace, and a gssr_tpu config.yml's partitioner, retrain, host,
writer and profiler fields loading into the port's."""
import dataclasses
import os
import sys
import types

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))


class RecordingWriter:
    """A stand-in for tensorboardX.SummaryWriter that keeps its calls."""
    made = []

    def __init__(self, logdir):
        self.logdir = logdir
        self.scalars = {}
        RecordingWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        assert (tag, step) not in self.scalars, (tag, step)
        self.scalars[(tag, step)] = float(value)

    def flush(self):
        pass


@pytest.fixture
def recording_writer(monkeypatch):
    module = types.ModuleType("tensorboardX")
    module.SummaryWriter = RecordingWriter
    monkeypatch.setitem(sys.modules, "tensorboardX", module)
    RecordingWriter.made = []
    return RecordingWriter


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("scene")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


def _configure(config, scene_dir, out_dir, last):
    config.source_path = scene_dir
    config.output_path = out_dir
    config.timestamp = "run"
    config.scene.gaussians = dataclasses.replace(config.scene.gaussians,
                                                 capacity=256)
    t = config.trainer
    t.iterations, t.log_interval = last, 1
    t.test_iterations, t.save_iterations = [last], []
    return config


def test_the_writer_gets_gssr_tpus_scalars(recording_writer, scene_dir,
                                           tmp_path):
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu.engine.trainer import Trainer as JTrainer
    from gssr_tpu_torch.configs.methods import get_method_config as t_config
    from gssr_tpu_torch.engine.trainer import Trainer as TTrainer
    from gssr_tpu_torch.models.convert import state_from_numpy

    # steps 48-50, as after a resume at 47: every step logs, step 50 is
    # also the perf point (50 log intervals) and the test iteration
    first, last = 48, 50
    jc = _configure(j_config("3dgs"), scene_dir, str(tmp_path / "j"), last)
    jc.scene.instance_cap = 4096
    jc.trainer.scan_block = 1
    tc = _configure(t_config("3dgs"), scene_dir, str(tmp_path / "t"), last)
    tc.machine.device = "cpu"
    jt, tt = JTrainer(jc), TTrainer(tc)
    jt.setup()
    tt.setup()
    tt.scene.state = state_from_numpy(
        [np.asarray(x) for x in jax.tree.leaves(jt.scene.state)], "cpu")
    jt.start_step = tt.start_step = first - 1
    jt.train()
    tt.train()

    jw, tw = recording_writer.made
    assert jw.logdir == str(tmp_path / "j" / os.path.basename(scene_dir)
                            / "3dgs" / "run" / "logs")
    assert tw.logdir == jw.logdir.replace(str(tmp_path / "j"),
                                          str(tmp_path / "t"))
    assert set(tw.scalars) == set(jw.scalars)
    tags = {tag for tag, _ in jw.scalars}
    assert {"train/loss", "train/L1_loss", "train/num_rendered",
            "perf/mpix_per_s", "eval/eval_psnr"} <= tags
    assert {s for tag, s in jw.scalars if tag == "train/loss"} == \
        set(range(first, last + 1))
    assert {s for tag, s in jw.scalars if not tag.startswith("train/")} \
        == {last}
    for key, want in jw.scalars.items():
        if key[0] != "perf/mpix_per_s":       # a host-clock rate
            np.testing.assert_allclose(tw.scalars[key], want, rtol=1e-3,
                                       err_msg=str(key))
    assert tw.scalars[("perf/mpix_per_s", last)] > 0


def test_the_profiler_window_writes_a_trace(recording_writer, scene_dir,
                                            tmp_path, capsys):
    from gssr_tpu_torch.configs.methods import get_method_config
    from gssr_tpu_torch.engine.trainer import Trainer
    config = _configure(get_method_config("3dgs"), scene_dir,
                        str(tmp_path / "out"), 4)
    config.machine.device = "cpu"
    config.writer = "none"
    config.trainer.profile_dir = str(tmp_path / "prof")
    config.trainer.profile_steps = [2, 3]
    trainer = Trainer(config)
    trainer.setup()
    trainer.train()
    assert trainer.writer is None and not recording_writer.made
    assert f"profiler trace written to {tmp_path / 'prof'}" in \
        capsys.readouterr().out
    traces = os.listdir(tmp_path / "prof")
    assert traces == ["trace_steps_2-3.json"]
    import json
    with open(tmp_path / "prof" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the window holds the blend's plain versions of steps 2 and 3
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]


def test_a_gssr_tpu_config_keeps_the_split_and_tool_fields(tmp_path, capsys):
    from gssr_tpu.configs.base import save_config_yaml
    from gssr_tpu.configs.methods import get_method_config
    from gssr_tpu_torch.configs.base import load_config_yaml
    config = get_method_config("octree-2dgs")
    config.source_path = "/data/scene"
    config.retrain = True
    config.writer, config.relative_log_dir = "none", "tb"
    config.machine.num_hosts, config.machine.host_rank = 3, 2
    config.trainer.profile_dir = "/data/prof"
    config.trainer.profile_steps = [5, 9]
    config.partitioner = dataclasses.replace(
        config.partitioner, need_partition=False, num_col=3, num_row=2,
        extend_ratio=0.2, visibility_threshold=0.25,
        config_of_tiles=["a.yml", "b.yml"])
    save_config_yaml(config, tmp_path / "config.yml")
    loaded = load_config_yaml(tmp_path / "config.yml")
    notes = capsys.readouterr().out
    assert loaded.retrain is True
    assert (loaded.writer, loaded.relative_log_dir) == ("none", "tb")
    assert (loaded.machine.num_hosts, loaded.machine.host_rank) == (3, 2)
    assert loaded.trainer.profile_dir == "/data/prof"
    assert loaded.trainer.profile_steps == [5, 9]
    assert dataclasses.asdict(loaded.partitioner) == \
        dataclasses.asdict(config.partitioner)
    assert type(loaded.partitioner).__name__ == "PartitionConfig"
    for field in ("retrain", "partitioner", "writer", "relative_log_dir",
                  "num_hosts", "host_rank", "profile_dir", "profile_steps"):
        assert f".{field} " not in notes, notes
    assert "TrainerConfig.scan_block" in notes
