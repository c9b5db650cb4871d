"""A scene's training callbacks, gathered and run as gssr_tpu's trainer
runs them: the trainer asks the scene for its hooks
(`get_training_callbacks(trainer)`) and runs each before and after every
train iteration. A VanillaScene subclass of each package registers the
same three hooks (every step; every second step after it; before step 3
only); both trainers, on the same tiny scene for the same steps, call
them at the same steps and locations, 2 x iterations times for the hook
of every step. The dataloaders' hooks are empty in both."""
import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))

STEPS = 4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("cb_scene")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


def _hooks(callbacks_module, calls):
    """The three hooks, appending (label, step, location name) to calls."""
    TC = callbacks_module.TrainingCallback
    Loc = callbacks_module.TrainingCallbackLocation
    both = [Loc.BEFORE_TRAIN_ITERATION, Loc.AFTER_TRAIN_ITERATION]

    def record(step, label, where):
        calls.append((label, step, where))
    return [TC("every", both, lambda s: record(s, "every", "both")),
            TC("second", [Loc.AFTER_TRAIN_ITERATION], record,
               update_every_num_iters=2, args=["second", "after"]),
            TC("at3", [Loc.BEFORE_TRAIN_ITERATION], record, iters=(3,),
               args=["at3", "before"])]


def _configure(config, scene_dir, out_dir):
    config.source_path, config.output_path = scene_dir, out_dir
    config.timestamp, config.writer = "run", "none"
    config.scene.gaussians = dataclasses.replace(config.scene.gaussians,
                                                 capacity=256)
    t = config.trainer
    t.iterations, t.log_interval = STEPS, 1
    t.test_iterations, t.save_iterations = [], []
    return config


def _run_gssr_tpu(scene_dir, out_dir):
    from gssr_tpu.configs.methods import get_method_config
    from gssr_tpu.engine import callbacks
    from gssr_tpu.engine.trainer import Trainer
    from gssr_tpu.scene.vanilla import VanillaScene

    calls, seen = [], []

    class Hooked(VanillaScene):
        def get_training_callbacks(self, trainer):
            seen.append(trainer)
            return _hooks(callbacks, calls)

    config = _configure(get_method_config("3dgs"), scene_dir, out_dir)
    config.scene.instance_cap = 4096
    config.trainer.scan_block = 1
    scene = Hooked(config.scene, scene_dir, seed=config.machine.seed)
    trainer = Trainer(config, scene=scene)
    trainer.setup()
    trainer.train()
    assert seen == [trainer]
    assert scene.dataloader.get_training_callbacks() == []
    return calls


def _run_port(scene_dir, out_dir):
    from gssr_tpu_torch.configs.methods import get_method_config
    from gssr_tpu_torch.engine import callbacks
    from gssr_tpu_torch.engine.trainer import Trainer
    from gssr_tpu_torch.scene.vanilla import VanillaScene

    calls, seen = [], []

    class Hooked(VanillaScene):
        def get_training_callbacks(self, trainer):
            seen.append(trainer)
            return _hooks(callbacks, calls)

    config = _configure(get_method_config("3dgs"), scene_dir, out_dir)
    config.machine.device = "cpu"
    scene = Hooked(config.scene, scene_dir, "cpu", seed=config.machine.seed)
    trainer = Trainer(config, scene=scene)
    trainer.setup()
    assert seen == [trainer] and [c.label for c in trainer.callbacks] == \
        ["every", "second", "at3"]
    trainer.train()
    assert scene.dataloader.get_training_callbacks() == []
    return calls


def test_a_scenes_callbacks_run_as_in_gssr_tpu(scene_dir, tmp_path):
    want = _run_gssr_tpu(scene_dir, str(tmp_path / "j"))
    got = _run_port(scene_dir, str(tmp_path / "t"))
    assert got == want
    every = [(s, w) for label, s, w in got if label == "every"]
    assert len(every) == 2 * STEPS
    assert [s for s, _ in every] == [s for s in range(1, STEPS + 1)
                                     for _ in range(2)]
    assert [(s, w) for label, s, w in got if label != "every"] == \
        [(2, "after"), (3, "before"), (4, "after")]


def test_the_presets_register_no_callbacks(scene_dir, tmp_path):
    """The nine methods' scenes keep VanillaScene's empty list, so no
    preset's training changes."""
    from gssr_tpu_torch.configs.methods import build_scene, get_method_config
    from gssr_tpu_torch.engine.trainer import Trainer
    from gssr_tpu_torch.scene import (octree, octree_2dgs, octree_pgsr, pgsr,
                                      scaffold, scaffold_2dgs,
                                      scaffold_pgsr, twodgs, vanilla)
    classes = [vanilla.VanillaScene, twodgs.TwoDGSScene, pgsr.PGSRScene,
               scaffold.ScaffoldScene, octree.OctreeScene,
               scaffold_2dgs.Scaffold2DGSScene, octree_2dgs.Octree2DGSScene,
               scaffold_pgsr.ScaffoldPGSRScene, octree_pgsr.OctreePGSRScene]
    for cls in classes:
        assert cls.get_training_callbacks is \
            vanilla.VanillaScene.get_training_callbacks, cls
    config = _configure(get_method_config("3dgs"), scene_dir,
                        str(tmp_path / "out"))
    config.machine.device = "cpu"
    trainer = Trainer(config, scene=build_scene(config, "cpu"))
    trainer.setup()
    assert trainer.callbacks == []
