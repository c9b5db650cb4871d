"""Scaffold-GS training in the port tracks gssr_tpu (its Pallas vanilla
blend in interpret mode) step for step from one carried-across state:
10 steps on the synthetic scene with adjust_anchor after steps 4 and 8
(anchors grown and pruned), the reference's uniform draws injected.
Losses at rtol 1e-3, num_rendered and the active masks exactly, the
statistics after every step and the final state leaf by leaf to 2e-4 of
each leaf's largest value. Also: a
gssr_tpu scaffold run's checkpoint and config.yml resume in the port and
train on, and each of the nine method presets equals gssr_tpu's.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

STEPS = 10
DENSIFY_EVERY = 4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("scene_scaffold")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


def _configure(config, scene_dir, out_dir):
    config.source_path = scene_dir
    config.output_path = out_dir
    config.scene.gaussians = dataclasses.replace(
        config.scene.gaussians, capacity=512, feat_dim=8, n_offsets=4,
        appearance_dim=4, voxel_size=0.1, start_stat=1,
        densify_from_iter=DENSIFY_EVERY - 1,
        densification_interval=DENSIFY_EVERY, densify_grad_threshold=2e-5,
        success_threshold=0.5, opacity_cull_threshold=0.25)
    return config


def _reference_draws(j_scene, cap, k):
    """The uniform draws gssr_tpu's next adjust_anchor takes: it splits
    the scene key, then that key once per level."""
    _, key = jax.random.split(j_scene.key)
    keys = jax.random.split(key, j_scene.config.gaussians.update_depth)
    return [torch.from_numpy(np.array(jax.random.uniform(kk, (cap, k))))
            for kk in keys]


def test_training_tracks_gssr_tpu(scene_dir, tmp_path):
    from gssr_tpu.configs.methods import build_scene as j_build
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu_torch.configs.methods import build_scene as t_build
    from gssr_tpu_torch.configs.methods import get_method_config as t_config
    from gssr_tpu_torch.models.convert import (
        scaffold_state_from_numpy,
        scaffold_state_to_numpy,
    )

    jc = _configure(j_config("scaffold-gs"), scene_dir, str(tmp_path / "j"))
    jc.scene.instance_cap = 8192
    jc.scene.backend = "pallas"
    tc = _configure(t_config("scaffold-gs"), scene_dir, str(tmp_path / "t"))
    js_, ts_ = j_build(jc), t_build(tc, "cpu")
    js = js_.state
    ts = scaffold_state_from_numpy([np.asarray(x)
                                    for x in jax.tree.leaves(js)], "cpu")
    cap, k = ts.anchors["offset"].shape[:2]
    grown = pruned = 0
    for step in range(1, STEPS + 1):
        jcam, tcam = js_.dataloader.next_train(), ts_.dataloader.next_train()
        assert jcam.image_name == tcam.image_name
        js, jm = js_.train_step(js, jcam, step)
        ts, tm = ts_.train_step(ts, tcam, step)
        assert not bool(jm["vb_overflow"]) and not bool(jm["overflow"])
        assert int(tm["num_rendered"]) == int(jm["num_rendered"]), step
        for term in ("loss", "L1_loss", "ssim_loss", "scaling_loss"):
            np.testing.assert_allclose(float(tm[term]), float(jm[term]),
                                       rtol=1e-3, err_msg=f"{step} {term}")
        assert float(tm["scaling_loss"]) > 0
        # the statistics after every step, before adjust_anchor resets them
        _assert_leaves_close(jax.tree.leaves(js.stats),
                             scaffold_state_to_numpy(ts)[71:75],
                             f"stats after step {step}")
        rands = _reference_draws(js_, cap, k)
        before = ts.active.clone()
        js = js_.densify(js, step)
        ts = ts_.densify(ts, step, rands=rands)
        np.testing.assert_array_equal(ts.active.numpy(),
                                      np.asarray(js.active))
        grown += int((ts.active & ~before).sum())
        pruned += int((before & ~ts.active).sum())
    assert grown > 0 and pruned > 0, (grown, pruned)

    _assert_leaves_close(jax.tree.leaves(js), scaffold_state_to_numpy(ts),
                         "final state")


def _assert_leaves_close(ref, got, what):
    """Every leaf to 2e-4 of its own largest value, so that the small ones
    (Adam's moments, the statistics) are held as tightly as the
    parameters."""
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"{what}, leaf {i}")


def test_a_gssr_tpu_scaffold_run_resumes_in_the_port(scene_dir, tmp_path,
                                                      capsys):
    """gssr_tpu's config.yml (its dropped fields noted) and checkpoint at
    step 3 load into the port, which trains on to step 5 on the CPU and
    writes the PLY, the _mlp.npz and GS-SR's checkpoints.pth."""
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu.engine.trainer import Trainer as JTrainer
    from gssr_tpu.models.scaffold import ScaffoldGaussians
    from gssr_tpu_torch import train
    from gssr_tpu_torch.configs.base import load_config_yaml
    from gssr_tpu_torch.engine.trainer import Trainer as TTrainer
    from gssr_tpu_torch.models.convert import scaffold_state_to_numpy

    jcfg = _configure(j_config("scaffold-gs"), scene_dir, str(tmp_path / "j"))
    jcfg.timestamp = "run"
    jcfg.save_config()
    jt = JTrainer(jcfg)
    jt.setup()
    for _ in range(3):
        jt.scene.dataloader.next_train()
    jt.save_checkpoint(jt.scene.state, 3)

    cfg = load_config_yaml(jcfg.get_base_dir() / "config.yml")
    out = capsys.readouterr().out
    for name in ("ScaffoldGaussianConfig.visible_budget_factor",
                 "ScaffoldSceneConfig.instance_cap"):
        assert out.count(f"dropped gssr_tpu field {name}") == 1, out
    assert cfg.scene.gaussians.n_offsets == 4
    cfg.machine.device = "cpu"
    cfg.output_path = str(tmp_path / "t")
    cfg.trainer.load_ckpt_dir = str(jt.ckpt_dir)

    tt = TTrainer(cfg)
    tt.setup()
    assert tt.start_step == 3
    for i, (a, b) in enumerate(zip(jax.tree.leaves(jt.scene.state),
                                   scaffold_state_to_numpy(tt.scene.state))):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"leaf {i}")
    assert tt.scene.dataloader.next_train().image_name == \
        jt.scene.dataloader.next_train().image_name

    cfg.trainer.iterations = 5
    cfg.trainer.test_iterations = [5]
    cfg.trainer.save_iterations = [5]
    cfg.trainer.log_interval = 1
    trainer = train.main(cfg)
    assert [h[0] for h in trainer.history] == [4, 5]
    assert all(np.isfinite(h[1]) for h in trainer.history)
    assert np.isfinite(trainer.evals[5]["eval_psnr"])
    d = cfg.get_gaussian_dir() / "iteration_5"
    for f in ("point_cloud.ply", "point_cloud_mlp.npz", "checkpoints.pth"):
        assert (d / f).stat().st_size > 0, f
    back = ScaffoldGaussians(jcfg.scene.gaussians).load_ply(
        str(d / "point_cloud.ply"))
    assert int(back.n_active) == int(trainer.scene.state.n_active)


METHODS = ["3dgs", "2dgs", "pgsr", "scaffold-gs", "octree-gs",
           "scaffold-2dgs", "octree-2dgs", "scaffold-pgsr", "octree-pgsr"]


def _fields(obj):
    """A config tree as (class name, {field: value}) nests, without the
    gssr_tpu fields the port has no counterpart for."""
    from gssr_tpu_torch.configs.base import FOREIGN_FIELDS
    if not dataclasses.is_dataclass(obj):
        return obj
    name = type(obj).__name__
    return (name, {f.name: _fields(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)
                   if f.name not in FOREIGN_FIELDS.get(name, {})})


@pytest.mark.parametrize("method", METHODS)
def test_every_preset_matches_gssr_tpu(method):
    """Each of the nine presets exists in the port, with gssr_tpu's scene
    and gaussian config classes and field values (leaving out
    configs/base.py::FOREIGN_FIELDS); the port's registry holds exactly
    these nine."""
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu_torch.configs.methods import (
        DESCRIPTIONS,
        METHOD_FACTORIES,
        get_method_config,
    )
    assert sorted(METHOD_FACTORIES) == sorted(DESCRIPTIONS) == sorted(METHODS)
    cfg, ref = get_method_config(method), j_config(method)
    assert cfg.method_name == method
    assert _fields(cfg.scene) == _fields(ref.scene)
    if "scaffold" in method or "octree" in method:
        g = cfg.scene.gaussians
        assert (g.feat_dim, g.n_offsets) == (32, 10)
        assert g.appearance_dim == (0 if method.startswith("octree")
                                    else 32)
