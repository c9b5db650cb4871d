"""The port's Octree-GS model (gssr_tpu_torch/models/octree.py and
models/convert.py's octree leaves) against gssr_tpu's:

* set_level, set_coarse_interval and create_from_points on the same points
  and cameras: the levels, the host attributes, the weeded-out positions,
  their levels and scales, and the capacity exactly (float64 numpy on both
  sides); the MLP draw differs by design and is carried across;
* pred_int_level in all four dist2level modes, with progressive training
  on and off, at steps on both sides of a coarse interval: the LOD mask
  exactly, the progressive gate to 1e-6;
* adjust_anchor_octree on seeded statistics that grow anchors at a level
  and at the next finer one and prune some: the active set and the levels
  exactly, every leaf to 2e-4 of its largest value;
* the PLY round trip both ways (gssr_tpu writes and the port reads, and
  the reverse), and the leaf conversion against jax.tree.leaves.
"""
import dataclasses
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CAP = 1024
N_PTS = 400


def _cameras(n=6, radius=3.0):
    """Camera positions on a tilted ring; set_level reads only campos."""
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        out.append(SimpleNamespace(campos=np.asarray(
            [radius * np.sin(a), 0.4 * np.cos(2 * a), -radius * np.cos(a)],
            np.float32)))
    return out


def _models(levels=3, seed=0, **cfg):
    """gssr_tpu's and the port's OctreeGaussians on one config, each
    initialised from the same points and cameras, and the reference's
    state (random features, offsets and extra levels) carried across with
    its host attributes."""
    from gssr_tpu.models.octree import OctreeGaussianConfig as JC
    from gssr_tpu.models.octree import OctreeGaussians as JG
    from gssr_tpu_torch.models.convert import (
        octree_state_from_numpy,
        set_octree_host_attrs,
    )
    from gssr_tpu_torch.models.octree import OctreeGaussianConfig as TC
    from gssr_tpu_torch.models.octree import OctreeGaussians as TG
    kw = dict(capacity=CAP, feat_dim=8, n_offsets=4, levels=levels)
    kw.update(cfg)
    jg, tg = JG(JC(**kw), num_cameras=6), TG(TC(**kw), num_cameras=6)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (N_PTS, 3))
    cams = _cameras()
    js = jg.create_from_points(pts, cameras=cams)
    ts0 = tg.create_from_points(pts, device="cpu", cameras=cams)
    for g in (jg, tg):
        g.set_coarse_interval(100, 1.5)
    an = js.anchors
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))   # noqa: E731
    act = np.asarray(js.active)
    js = js._replace(
        anchors=an._replace(
            feat=f32(rng.normal(size=an.feat.shape)),
            offset=f32(rng.normal(size=an.offset.shape))),
        extra_level=f32(rng.uniform(-0.4, 0.4, CAP) * act))
    ts = octree_state_from_numpy([np.asarray(x)
                                  for x in jax.tree.leaves(js)], "cpu")
    set_octree_host_attrs(
        tg, levels=jg.levels, init_level=jg.init_level,
        standard_dist=jg.standard_dist, voxel_size=jg.voxel_size,
        init_pos=jg.init_pos, cam_infos=jg.cam_infos,
        visible_threshold=jg.visible_threshold,
        coarse_intervals=jg.coarse_intervals)
    return jg, tg, js, ts, ts0


@pytest.mark.parametrize("levels", [-1, 3])
def test_create_from_points_matches_gssr_tpu_but_the_mlp_draw(levels):
    from gssr_tpu_torch.models.scaffold import ANCHOR_NAMES
    jg, tg, js, _, ts = _models(levels=levels)
    for name in ("levels", "init_level", "standard_dist", "voxel_size",
                 "visible_threshold", "coarse_intervals"):
        assert getattr(tg, name) == getattr(jg, name), name
    np.testing.assert_array_equal(tg.init_pos, jg.init_pos)
    np.testing.assert_array_equal(tg.cam_infos, jg.cam_infos)
    assert ts.active.shape[0] == CAP
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    assert int(ts.n_active) == int(js.n_active)
    np.testing.assert_array_equal(ts.level.numpy(), np.asarray(js.level))
    np.testing.assert_array_equal(ts.extra_level.numpy(), 0.0)
    jan = jax.tree.map(np.asarray, js.anchors)
    for k in ("anchor", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(ts.anchors[k].numpy(), getattr(jan, k),
                                      err_msg=k)
    assert set(ts.anchors) == set(ANCHOR_NAMES)
    # with three levels the weed-out keeps more than one (with the
    # derived two, only level 0 survives it here), and the MLP has the
    # reference's shapes
    n = int(js.n_active)
    kept = len(np.unique(np.asarray(js.level)[:n]))
    assert kept > 1 if levels == 3 else kept == 1, kept
    for k, v in zip(ts.mlp, js.mlp):
        assert tuple(ts.mlp[k].shape) == tuple(v.shape), k


MODES = ["floor", "round", "ceil", "progressive"]


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["all-levels", "progressive"])
@pytest.mark.parametrize("mode", MODES)
def test_pred_int_level_equals_gssr_tpu(mode, progressive):
    from gssr_tpu_torch.models.convert import octree_state_from_numpy
    jg, tg, js, _, _ = _models(levels=5, dist2level=mode,
                               progressive=progressive)
    # every level present: the weed-out keeps only the coarser ones here
    rng = np.random.default_rng(7)
    js = js._replace(level=jnp.asarray(
        rng.integers(0, 5, CAP).astype(np.int32) * np.asarray(js.active)))
    ts = octree_state_from_numpy([np.asarray(x)
                                  for x in jax.tree.leaves(js)], "cpu")
    assert len(jg.coarse_intervals) >= 1
    first = jg.coarse_intervals[0]
    dropped, masks = 0, {}
    for campos, step, training in itertools.product(
            (np.asarray([0.3, -0.2, 1.3], np.float32),
             np.asarray([-1.0, 0.5, 5.0], np.float32)),
            (int(first) - 1, int(first) + 1, 10 ** 6), (True, False)):
        jm, jgate = jg.pred_int_level(js, jnp.asarray(campos),
                                      jnp.asarray(step, jnp.float32),
                                      training)
        tm, tgate = tg.pred_int_level(ts, torch.from_numpy(campos), step,
                                      training)
        what = f"{mode} step {step} training {training}"
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm),
                                      err_msg=what)
        if jgate is None:
            assert tgate is None, what
        else:
            np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate),
                                       rtol=0, atol=1e-6, err_msg=what)
        dropped += int((ts.active & ~tm).sum())
        masks[(round(float(campos[2]), 3), step, training)] = tm
    assert dropped > 0
    # the progressive schedule opens a level between the two steps
    opened = any(not torch.equal(masks[(z, int(first) - 1, True)],
                                 masks[(z, int(first) + 1, True)])
                 for z in (1.3, 5.0))
    assert opened == progressive


@pytest.mark.parametrize("seed", [0, 1])
def test_adjust_anchor_octree_equals_gssr_tpu(seed):
    """Statistics drawn so that offsets pass the thresholds of their own
    level and of the next finer one, and some anchors are pruned."""
    from gssr_tpu.models.scaffold import ScaffoldStats
    from gssr_tpu_torch.models.convert import (
        octree_state_from_numpy,
        octree_state_to_numpy,
    )
    jg, tg, js, _, _ = _models(levels=3, seed=seed,
                               densification_interval=10,
                               densify_grad_threshold=2e-4,
                               opacity_cull_threshold=0.2)
    rng = np.random.default_rng(10 + seed)
    act = np.asarray(js.active)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32) *   # noqa: E731
                                act.reshape((-1,) + (1,) * (a.ndim - 1)))
    stats = ScaffoldStats(
        opacity_accum=f32(rng.uniform(0, 4, CAP)),
        anchor_denom=f32(rng.integers(5, 15, CAP)),
        offset_grad_accum=f32(rng.uniform(0, 3e-3, (CAP, 4))),
        offset_denom=f32(rng.integers(0, 10, (CAP, 4))))
    sc = np.asarray(js.anchors.scaling).copy()
    sc[:, 3:] = rng.uniform(-3.0, 1.0, (CAP, 3))
    js = js._replace(stats=stats,
                     anchors=js.anchors._replace(scaling=jnp.asarray(sc)))
    ts = octree_state_from_numpy([np.asarray(x)
                                  for x in jax.tree.leaves(js)], "cpu")
    js2 = jg.adjust_anchor_octree(js, jax.random.PRNGKey(seed),
                                  jnp.asarray(20.0, jnp.float32))
    ts2 = tg.adjust_anchor_octree(ts, 20)

    aj, at = np.asarray(js2.active), ts2.active.numpy()
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(ts2.level.numpy(), np.asarray(js2.level))
    new = aj & ~act
    pruned = int((act & ~aj).sum())
    new_levels = set(np.asarray(js2.level)[new].tolist())
    # grown at a level with features and at the next finer one without
    zero_feat = (np.abs(np.asarray(js2.anchors.feat)[new]).sum(1) == 0)
    assert len(new_levels) >= 2 and zero_feat.any() and (~zero_feat).any(), \
        (new_levels, int(zero_feat.sum()))
    assert pruned > 0
    assert (np.asarray(js2.extra_level) > np.asarray(js.extra_level)).any()
    for i, (a, b) in enumerate(zip(jax.tree.leaves(js2),
                                   octree_state_to_numpy(ts2))):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=f"leaf {i}")


def test_ply_round_trips_both_ways(tmp_path):
    from gssr_tpu.models.octree import OctreeGaussians as JG
    from gssr_tpu_torch.models.octree import OctreeGaussians as TG
    from gssr_tpu_torch.models.scaffold import ANCHOR_NAMES
    jg, tg, js, ts, _ = _models(levels=3)
    n = int(ts.n_active)
    act = ts.active.numpy()
    tg.save_ply(ts, str(tmp_path / "t.ply"))
    jg.save_ply(js, str(tmp_path / "j.ply"))
    for name in ("t.ply", "j.ply"):
        fresh = TG(tg.config)
        back = fresh.load_ply(str(tmp_path / name), "cpu", capacity=CAP)
        assert int(back.n_active) == n
        assert fresh.voxel_size == np.float32(jg.voxel_size)
        assert fresh.standard_dist == np.float32(jg.standard_dist)
        assert fresh.levels == 3
        for k in ANCHOR_NAMES:
            np.testing.assert_array_equal(back.anchors[k].numpy()[:n],
                                          ts.anchors[k].numpy()[act],
                                          err_msg=f"{name} {k}")
        np.testing.assert_array_equal(back.level.numpy()[:n],
                                      ts.level.numpy()[act])
        np.testing.assert_array_equal(back.extra_level.numpy()[:n],
                                      ts.extra_level.numpy()[act])
    jfresh = JG(jg.config)
    jback = jfresh.load_ply(str(tmp_path / "t.ply"), capacity=CAP)
    assert jfresh.voxel_size == np.float32(tg.voxel_size)
    np.testing.assert_array_equal(np.asarray(jback.level)[:n],
                                  ts.level.numpy()[act])
    np.testing.assert_array_equal(np.asarray(jback.extra_level)[:n],
                                  ts.extra_level.numpy()[act])
    for k in ANCHOR_NAMES:
        np.testing.assert_array_equal(
            np.asarray(getattr(jback.anchors, k))[:n],
            ts.anchors[k].numpy()[act], err_msg=k)


def test_leaf_conversion_round_trips():
    from gssr_tpu_torch.models.convert import (
        N_OCTREE_LEAVES,
        octree_state_from_numpy,
        octree_state_to_numpy,
    )
    from gssr_tpu_torch.models.octree import OctreeState
    _, _, js, ts, _ = _models(levels=3)
    leaves = jax.tree.leaves(js)
    assert len(leaves) == N_OCTREE_LEAVES == 79
    assert isinstance(ts, OctreeState)
    assert ts.level.dtype == torch.int32 and ts.active.dtype == torch.bool
    back = octree_state_to_numpy(ts)
    for i, (a, b) in enumerate(zip(leaves, back)):
        assert np.asarray(a).dtype == b.dtype, i
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"leaf {i}")
    again = octree_state_to_numpy(octree_state_from_numpy(back, "cpu"))
    for a, b in zip(back, again):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="79"):
        octree_state_from_numpy(back[:-1], "cpu")
    assert dataclasses.is_dataclass(ts)


def test_voxel_coordinates_round_as_the_jitted_reference():
    """gssr_tpu's jitted densify divides by a voxel size that is a
    compile-time constant, which XLA turns into a multiply by its float32
    reciprocal. On points half-way between voxel centres (where an offset
    of the voxel grid puts them) that rounds apart from a true division;
    the port's grow multiplies by the same reciprocal
    (models/scaffold.py::reciprocal_f32) and rounds as the reference."""
    from gssr_tpu_torch.models.scaffold import reciprocal_f32
    k = np.arange(-2000, 2000)
    for size in (0.4, 1.6, 0.2 / 3):
        x = ((k + 0.5) * size).astype(np.float32)[:, None].repeat(3, 1)
        ref = np.asarray(jax.jit(lambda a: jnp.round(a / size))(x))
        got = torch.round(torch.from_numpy(x) * reciprocal_f32(size, "cpu"))
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(size))
        true_div = torch.round(torch.from_numpy(x) / torch.tensor(
            size, dtype=torch.float32)).numpy()
        assert (true_div != ref).sum() > 100, size
