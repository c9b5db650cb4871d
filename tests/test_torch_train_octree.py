"""Octree-GS training in the port tracks gssr_tpu (its Pallas vanilla blend
in interpret mode) step for step from one carried-across state: 10 steps
of the `octree-gs` preset (three levels) on the synthetic scene, with
adjust_anchor_octree after steps 4 and 8 growing anchors. Losses at rtol
1e-3, num_rendered, the active masks and the levels exactly, the
statistics after every step and the final state leaf by leaf to 2e-4 of
each leaf's largest value; the LOD mask drops active anchors on some
render. The octree model's host attributes (levels, voxel size, cameras)
are carried across with the state.

`track_gssr_tpu` runs every anchor method's parity test
(tests/test_torch_train_anchor2d.py, test_torch_train_anchor_pgsr.py).
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
    d = tmp_path_factory.mktemp("scene_octree")
    write_synthetic_colmap_scene(str(d), n_cams=4, n_pts=64, width=32,
                                 height=32)
    return str(d)


def configure(config, scene_dir, out_dir, **scene):
    """The anchor presets cut to the test scene: narrow MLPs, statistics
    from step 1, adjust_anchor after every DENSIFY_EVERY steps from step
    4, thresholds that grow and prune anchors there; three octree levels.
    `scene` sets fields of the scene config."""
    config.source_path = scene_dir
    config.output_path = out_dir
    g = config.scene.gaussians
    extra = {"levels": 3} if hasattr(g, "levels") else {
        "appearance_dim": 4, "voxel_size": 0.1}
    config.scene.gaussians = dataclasses.replace(
        g, capacity=512, feat_dim=8, n_offsets=4, start_stat=1,
        densify_from_iter=DENSIFY_EVERY - 1,
        densification_interval=DENSIFY_EVERY, densify_grad_threshold=2e-5,
        success_threshold=0.5, opacity_cull_threshold=0.25, **extra)
    for k, v in scene.items():
        setattr(config.scene, k, v)
    return config


def _reference_draws(j_scene, cap, k):
    """The uniform draws gssr_tpu's next scaffold adjust_anchor takes."""
    _, key = jax.random.split(j_scene.key)
    keys = jax.random.split(key, j_scene.config.gaussians.update_depth)
    return [torch.from_numpy(np.array(jax.random.uniform(kk, (cap, k))))
            for kk in keys]


def _record_picks(scene):
    picks, choose = [], scene.key_host_choice

    def record(ids):
        picks.append(choose(ids))
        return picks[-1]
    scene.key_host_choice = record
    return picks


def assert_leaves_close(ref, got, what):
    """Every leaf to 2e-4 of its own largest value."""
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"{what}, leaf {i}")


def track_gssr_tpu(method, scene_dir, out_dir, first_step=1, steps=STEPS,
                   resync=False, **scene):
    """Train `method` in gssr_tpu and in the port from one carried-across
    state and compare them after every step (see the module docstring).
    gssr_tpu's scaffold adjust_anchor draws and neighbour picks are
    injected. With `resync`, the port continues from gssr_tpu's state
    after every step but the last, so that no step inherits the other's
    rounding; the final state is then that of one step (and densify) from
    a shared state. Returns the
    port's per-step metrics, the anchors grown and pruned, the active
    anchors the LOD mask dropped (octree methods) and the neighbours
    drawn."""
    from gssr_tpu.configs.methods import build_scene as j_build
    from gssr_tpu.configs.methods import get_method_config as j_config
    from gssr_tpu_torch.configs.methods import build_scene as t_build
    from gssr_tpu_torch.configs.methods import get_method_config as t_config
    from gssr_tpu_torch.models.convert import set_octree_host_attrs
    from gssr_tpu_torch.models.octree import OctreeGaussians

    jc = configure(j_config(method), scene_dir, os.path.join(out_dir, "j"),
                   instance_cap=8192, backend="pallas", **scene)
    tc = configure(t_config(method), scene_dir, os.path.join(out_dir, "t"),
                   **scene)
    js_, ts_ = j_build(jc), t_build(tc, "cpu")
    octree = isinstance(ts_.gaussians, OctreeGaussians)
    if octree:
        jg = js_.gaussians
        set_octree_host_attrs(
            ts_.gaussians, levels=jg.levels, init_level=jg.init_level,
            standard_dist=jg.standard_dist, voxel_size=jg.voxel_size,
            init_pos=jg.init_pos, cam_infos=jg.cam_infos,
            visible_threshold=jg.visible_threshold,
            coarse_intervals=jg.coarse_intervals)
    js = js_.state
    ts = ts_.state_from_numpy([np.asarray(x) for x in jax.tree.leaves(js)])
    n_leaves = len(jax.tree.leaves(js))
    picks_j = picks_t = None
    if hasattr(ts_, "key_host_choice"):
        assert [c.near_ids for c in ts_.dataloader.train_cameras] == \
            [c.near_ids for c in js_.dataloader.train_cameras]
        picks_j, picks_t = _record_picks(js_), _record_picks(ts_)
    cap, k = ts.anchors["offset"].shape[:2]
    history, grown, pruned, dropped = [], 0, 0, 0
    for step in range(first_step, first_step + steps):
        jcam, tcam = js_.dataloader.next_train(), ts_.dataloader.next_train()
        assert jcam.image_name == tcam.image_name
        if octree:
            mask, _ = ts_.anchor_level_gate(ts, tcam.arrays("cpu"), step)
            dropped += int((ts.active & ~mask).sum())
        js, jm = js_.train_step(js, jcam, step)
        ts, tm = ts_.train_step(ts, tcam, step)
        assert not bool(jm["vb_overflow"]) and not bool(jm["overflow"])
        assert picks_t == picks_j, step
        assert int(tm["num_rendered"]) == int(jm["num_rendered"]), step
        terms = [t for t in jm if t == "loss" or t.endswith("_loss")]
        assert sorted(terms) == sorted(
            t for t in tm if t == "loss" or t.endswith("_loss")), step
        for term in terms:
            np.testing.assert_allclose(float(tm[term]), float(jm[term]),
                                       rtol=1e-3, atol=1e-7,
                                       err_msg=f"{step} {term}")
        history.append({t: float(v) for t, v in tm.items()})
        leaves = ts_.state_to_numpy(ts)
        assert len(leaves) == n_leaves
        assert_leaves_close(jax.tree.leaves(js.stats), leaves[71:75],
                            f"stats after step {step}")
        before = ts.active.clone()
        if octree:
            ts = ts_.densify(ts, step)
        else:
            ts = ts_.densify(ts, step, rands=_reference_draws(js_, cap, k))
        js = js_.densify(js, step)
        np.testing.assert_array_equal(ts.active.numpy(),
                                      np.asarray(js.active))
        if octree:
            np.testing.assert_array_equal(ts.level.numpy(),
                                          np.asarray(js.level))
        grown += int((ts.active & ~before).sum())
        pruned += int((before & ~ts.active).sum())
        if resync and step < first_step + steps - 1:
            ts = ts_.state_from_numpy([np.asarray(x)
                                       for x in jax.tree.leaves(js)])
    assert_leaves_close(jax.tree.leaves(js), ts_.state_to_numpy(ts),
                        "final state")
    return history, grown, pruned, dropped, picks_t


def test_octree_gs_training_tracks_gssr_tpu(scene_dir, tmp_path):
    history, grown, pruned, dropped, _ = track_gssr_tpu(
        "octree-gs", scene_dir, str(tmp_path))
    assert grown > 0, grown
    assert dropped > 0, "the LOD mask dropped no active anchor"
    assert all(h["scaling_loss"] >= 0 for h in history)
