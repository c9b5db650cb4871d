"""The port's Scaffold-GS model (gssr_tpu_torch/models/scaffold.py,
models/interop.py, models/convert.py) against gssr_tpu's, with the state
(anchors, MLP, Adam, statistics) carried across by scaffold_state_from_numpy:

* decode, with and without the feature bank, the add_*_dist inputs and
  the appearance embedding: geometry at atol = rtol = 1e-5, the masks
  exactly. gssr_tpu decodes a static budget of compacted visible anchors,
  the port the visible ones exactly; their rows agree in order;
* gradients through decode into anchors and MLP at atol 2e-4, rtol 2e-3
  (tests/test_blend_pallas.py's gradient tolerance);
* update_stats and expand_stats_inputs;
* adjust_anchor with the reference's uniform draws injected: the active
  set and the new anchors exactly, every other leaf to 1e-5 of its
  largest value;
* PLY, .npz and GS-SR checkpoints.pth round trips, and files written by
  gssr_tpu read by the port (as tests/test_interop.py does for gssr_tpu).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CAP = 256
DECODE_CASES = {
    "preset": {},
    "feat_bank": {"use_feat_bank": True},
    "dist_inputs": {"add_opacity_dist": True, "add_cov_dist": True,
                    "add_color_dist": True},
    "no_appearance": {"appearance_dim": 0},
}


def _models(seed=0, n_pts=60, **cfg):
    """gssr_tpu's and the port's ScaffoldGaussians on one config, and one
    state (random features, offsets, scales and MLP) on both sides."""
    from gssr_tpu.models.scaffold import ScaffoldGaussianConfig as JC
    from gssr_tpu.models.scaffold import ScaffoldGaussians as JG
    from gssr_tpu_torch.models.convert import scaffold_state_from_numpy
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussianConfig as TC
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussians as TG
    kw = dict(capacity=CAP, feat_dim=8, n_offsets=4, appearance_dim=4,
              voxel_size=0.05)
    kw.update(cfg)
    jg = JG(JC(**kw), spatial_lr_scale=2.0, num_cameras=5)
    tg = TG(TC(**kw), spatial_lr_scale=2.0, num_cameras=5)
    rng = np.random.default_rng(seed)
    js = jg.create_from_points(rng.uniform(-1, 1, (n_pts, 3)))
    an, mlp = js.anchors, js.mlp
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))   # noqa: E731
    an = an._replace(
        feat=f32(rng.normal(size=an.feat.shape)),
        offset=f32(rng.normal(size=an.offset.shape)),
        scaling=an.scaling + f32(rng.uniform(-0.5, 0.5, an.scaling.shape)))
    mlp = mlp._replace(appearance=f32(rng.normal(
        size=mlp.appearance.shape)))
    js = js._replace(anchors=an, mlp=mlp)
    ts = scaffold_state_from_numpy([np.asarray(x)
                                    for x in jax.tree.leaves(js)], "cpu")
    return jg, tg, js, ts


def _decode_inputs(js, seed=1):
    rng = np.random.default_rng(seed)
    visible = rng.random(CAP) < 0.7
    campos = np.asarray([0.3, -0.2, 3.5], np.float32)
    return visible, campos


def _both_decodes(jg, tg, js, ts, visible, campos, cam_uid=2):
    ngj = jg.decode(js.anchors, js.mlp, jnp.asarray(campos), cam_uid,
                    jnp.asarray(visible), js.active)
    ngt = tg.decode(ts.anchors, ts.mlp, torch.from_numpy(campos), cam_uid,
                    torch.from_numpy(visible), ts.active)
    return ngj, ngt


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_equals_gssr_tpu(case):
    jg, tg, js, ts = _models(**DECODE_CASES[case])
    visible, campos = _decode_inputs(js)
    ngj, ngt = _both_decodes(jg, tg, js, ts, visible, campos)
    n = ngt.xyz.shape[0]
    live = visible & np.asarray(js.active)
    assert n == int(live.sum()) * 4 and n > 0
    np.testing.assert_array_equal(ngt.anchor_idx.numpy(),
                                  np.flatnonzero(live))
    np.testing.assert_array_equal(np.asarray(ngj.anchor_idx)[:n // 4],
                                  np.flatnonzero(live))
    # the reference's rows past the visible anchors are masked off
    assert not np.asarray(ngj.mask)[n:].any()
    np.testing.assert_array_equal(ngt.mask.numpy(), np.asarray(ngj.mask)[:n])
    assert 0 < int(ngt.mask.sum()) < n
    for f in ("xyz", "color", "opacity", "scaling", "rotation",
              "neural_opacity"):
        np.testing.assert_allclose(getattr(ngt, f).numpy(),
                                   np.asarray(getattr(ngj, f))[:n],
                                   atol=1e-5, rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("case", ["preset", "feat_bank"])
def test_decode_gradients_equal_gssr_tpu(case):
    """A random linear functional of every decoded output, differentiated
    into the anchors and the MLP on both sides."""
    from gssr_tpu_torch.models.scaffold import ANCHOR_NAMES, MLP_NAMES
    jg, tg, js, ts = _models(**DECODE_CASES[case])
    visible, campos = _decode_inputs(js)
    live = visible & np.asarray(js.active)
    n = int(live.sum()) * 4
    rng = np.random.default_rng(7)
    fields = ("xyz", "color", "opacity", "scaling", "rotation")
    widths = {"xyz": 3, "color": 3, "opacity": 0, "scaling": 3,
              "rotation": 4}
    vb = jg.visible_budget(CAP) * 4
    w = {f: rng.normal(size=(n,) + ((widths[f],) if widths[f] else ()))
         .astype(np.float32) for f in fields}

    def j_loss(anchors, mlp):
        ng = jg.decode(anchors, mlp, jnp.asarray(campos), 2,
                       jnp.asarray(visible), js.active)
        tot = 0.0
        for f in fields:
            pad = np.zeros((vb - n,) + w[f].shape[1:], np.float32)
            tot = tot + jnp.sum(getattr(ng, f)
                                * jnp.asarray(np.concatenate([w[f], pad])))
        return tot

    gaj, gmj = jax.grad(j_loss, argnums=(0, 1))(js.anchors, js.mlp)
    anchors = {k: v.clone().requires_grad_(True)
               for k, v in ts.anchors.items()}
    mlp = {k: v.clone().requires_grad_(True) for k, v in ts.mlp.items()}
    ng = tg.decode(anchors, mlp, torch.from_numpy(campos), 2,
                   torch.from_numpy(visible), ts.active)
    loss = sum((getattr(ng, f) * torch.from_numpy(w[f])).sum()
               for f in fields)
    loss.backward()
    for k in ANCHOR_NAMES:
        want = np.asarray(getattr(gaj, k))
        got = (anchors[k].grad.numpy() if anchors[k].grad is not None
               else np.zeros_like(want))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3,
                                   err_msg=k)
    for k in MLP_NAMES:
        want = np.asarray(getattr(gmj, k))
        got = (mlp[k].grad.numpy() if mlp[k].grad is not None
               else np.zeros_like(want))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3,
                                   err_msg=k)
    assert np.abs(np.asarray(gaj.offset)).max() > 1e-3
    if case == "feat_bank":
        assert np.abs(np.asarray(gmj.fb_w1)).max() > 1e-4


def test_update_stats_equal_gssr_tpu():
    jg, tg, js, ts = _models()
    visible, campos = _decode_inputs(js)
    ngj, ngt = _both_decodes(jg, tg, js, ts, visible, campos)
    n = ngt.xyz.shape[0]
    vbk = ngj.xyz.shape[0]
    rng = np.random.default_rng(4)
    radii = rng.integers(0, 3, vbk).astype(np.int32)
    m2d = rng.normal(size=(vbk, 2)).astype(np.float32) * 1e-3
    stats_np = {"opacity_accum": rng.random(CAP), "anchor_denom":
                rng.integers(0, 5, CAP), "offset_grad_accum":
                rng.random((CAP, 4)), "offset_denom": rng.integers(0, 5,
                                                                   (CAP, 4))}
    stats_np = {k: np.asarray(v, np.float32) for k, v in stats_np.items()}
    from gssr_tpu.models.scaffold import ScaffoldStats
    scale = np.asarray([16.0, 12.0], np.float32)
    sj = jg.update_stats(
        ScaffoldStats(**{k: jnp.asarray(v) for k, v in stats_np.items()}),
        *jg.expand_stats_inputs(ngj, jnp.asarray(radii), jnp.asarray(m2d),
                                CAP),
        jnp.asarray(visible), js.active, jnp.asarray(scale))
    st = tg.update_stats(
        {k: torch.from_numpy(v) for k, v in stats_np.items()},
        *tg.expand_stats_inputs(ngt, torch.from_numpy(radii[:n]),
                                torch.from_numpy(m2d[:n]), CAP),
        torch.from_numpy(visible), ts.active, torch.from_numpy(scale))
    for k in stats_np:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(getattr(sj, k)),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        assert not np.array_equal(st[k].numpy(), stats_np[k]), k


def _draws(key, cfg):
    """The reference's per-level uniform draws from key `key`."""
    keys = jax.random.split(key, cfg.update_depth)
    return [np.array(jax.random.uniform(k, (CAP, cfg.n_offsets)))
            for k in keys]


@pytest.mark.parametrize("seed", [0, 1])
def test_adjust_anchor_equals_gssr_tpu(seed):
    """Statistics drawn so that anchors grow at every level and some are
    pruned; the reference's draws are injected."""
    from gssr_tpu.models.scaffold import ScaffoldStats
    from gssr_tpu_torch.models.convert import (
        scaffold_state_from_numpy,
        scaffold_state_to_numpy,
    )
    jg, tg, js, _ = _models(seed=seed, n_pts=80, densification_interval=10,
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
    # columns 3-5 of the log scaling partly above the prune pass's clamp
    sc = np.asarray(js.anchors.scaling).copy()
    sc[:, 3:] = rng.uniform(-3.0, 1.0, (CAP, 3))
    js = js._replace(stats=stats,
                     anchors=js.anchors._replace(scaling=jnp.asarray(sc)))
    ts = scaffold_state_from_numpy([np.asarray(x)
                                    for x in jax.tree.leaves(js)], "cpu")
    key = jax.random.PRNGKey(seed)
    rands = [torch.from_numpy(r) for r in _draws(key, jg.config)]
    js2 = jg.adjust_anchor(js, key, jg.voxel_size)
    ts2 = tg.adjust_anchor(ts, tg.voxel_size, rands=rands)

    a0, aj, at = act, np.asarray(js2.active), ts2.active.numpy()
    np.testing.assert_array_equal(at, aj)
    grown, pruned = int((aj & ~a0).sum()), int((a0 & ~aj).sum())
    assert grown > 0 and pruned > 0, (grown, pruned)
    new = aj & ~a0
    for k in ("anchor", "feat", "scaling", "offset", "rotation", "opacity"):
        np.testing.assert_array_equal(ts2.anchors[k].numpy()[new],
                                      np.asarray(getattr(js2.anchors, k))[new],
                                      err_msg=k)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(js2),
                                   scaffold_state_to_numpy(ts2))):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"leaf {i}")


def test_ply_and_mlp_files_round_trip_and_cross(tmp_path):
    """The port's PLY, _mlp.npz and checkpoints.pth read back exactly by
    the port and by gssr_tpu; gssr_tpu's PLY and _mlp.npz read by the
    port."""
    from gssr_tpu.models.interop import load_gs_sr_mlp_checkpoint as j_load
    from gssr_tpu_torch.models.interop import load_gs_sr_mlp_checkpoint
    from gssr_tpu_torch.models.scaffold import ANCHOR_NAMES, MLP_NAMES
    jg, tg, js, ts = _models(use_feat_bank=True)
    n = int(ts.n_active)
    act = ts.active.numpy()
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    tdir.mkdir()
    jdir.mkdir()
    tg.save_ply(ts, str(tdir / "point_cloud.ply"))
    tg.save_mlp_checkpoints(ts, str(tdir / "point_cloud_mlp.npz"))
    assert (tdir / "checkpoints.pth").exists()
    jg.save_ply(js, str(jdir / "point_cloud.ply"))
    jg.save_mlp_checkpoints(js, str(jdir / "point_cloud_mlp.npz"))

    for d in (tdir, jdir):
        back = tg.load_ply(str(d / "point_cloud.ply"), "cpu", capacity=CAP)
        back = tg.load_mlp_checkpoints(back, str(d / "point_cloud_mlp.npz"))
        assert int(back.n_active) == n
        for k in ANCHOR_NAMES:
            np.testing.assert_array_equal(back.anchors[k].numpy()[:n],
                                          ts.anchors[k].numpy()[act],
                                          err_msg=f"{d.name} {k}")
        for k in MLP_NAMES:
            np.testing.assert_array_equal(back.mlp[k].numpy(),
                                          ts.mlp[k].numpy(), err_msg=k)
    jback = jg.load_ply(str(tdir / "point_cloud.ply"), capacity=CAP)
    jback = jg.load_mlp_checkpoints(jback,
                                    str(tdir / "point_cloud_mlp.npz"))
    for k in ANCHOR_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(jback.anchors,
                                                         k))[:n],
                                      ts.anchors[k].numpy()[act], err_msg=k)
    # GS-SR's checkpoints.pth: the port's own import and gssr_tpu's
    mlp = {k: torch.zeros_like(v) for k, v in ts.mlp.items()}
    got = load_gs_sr_mlp_checkpoint(str(tdir), mlp)
    jgot = j_load(str(tdir), js.mlp._replace(
        **{k: jnp.zeros_like(getattr(js.mlp, k)) for k in MLP_NAMES}))
    for k in MLP_NAMES:
        np.testing.assert_array_equal(got[k].numpy(), ts.mlp[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(np.asarray(getattr(jgot, k)),
                                      ts.mlp[k].numpy(), err_msg=k)


def test_split_mode_traces_load_as_in_gssr_tpu(tmp_path):
    """GS-SR's split-mode torch.jit traces (three heads and the appearance
    embedding) import as gssr_tpu imports them, and a checkpoint of the
    wrong width raises."""
    from gssr_tpu.models.interop import load_gs_sr_mlp_checkpoint as j_load
    from gssr_tpu_torch.models.interop import load_gs_sr_mlp_checkpoint
    from gssr_tpu_torch.models.scaffold import MLP_NAMES
    jg, tg, js, ts = _models()
    torch.manual_seed(0)

    def seq(w1, w2, act):
        return torch.nn.Sequential(
            torch.nn.Linear(w1.shape[0], w1.shape[1]), torch.nn.ReLU(),
            torch.nn.Linear(w2.shape[0], w2.shape[1]), act)

    m = ts.mlp
    for fname, mod in (
            ("opacity_mlp.pt", seq(m["op_w1"], m["op_w2"], torch.nn.Tanh())),
            ("cov_mlp.pt", seq(m["cov_w1"], m["cov_w2"],
                               torch.nn.Identity())),
            ("color_mlp.pt", seq(m["col_w1"], m["col_w2"],
                                 torch.nn.Sigmoid()))):
        mod = mod.eval()
        torch.jit.trace(mod, torch.rand(1, mod[0].weight.shape[1])).save(
            str(tmp_path / fname))

    class Emb(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = torch.nn.Embedding(3, 4)

        def forward(self, i):
            return self.embedding(i)

    torch.jit.trace(Emb(), torch.zeros(1, dtype=torch.long)).save(
        str(tmp_path / "embedding_appearance.pt"))
    got = load_gs_sr_mlp_checkpoint(str(tmp_path), ts.mlp)
    want = j_load(str(tmp_path), js.mlp)
    for k in MLP_NAMES:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    assert got["appearance"].shape == (5, 4)
    assert not torch.equal(got["cov_w2"], ts.mlp["cov_w2"])
    wide = dict(ts.mlp, op_w1=torch.zeros(ts.mlp["op_w1"].shape[0] + 1, 8))
    with pytest.raises(ValueError, match="op_w1"):
        load_gs_sr_mlp_checkpoint(str(tmp_path), wide)


def test_learning_rates_equal_gssr_tpu():
    """Every group's rate at a few steps, frozen leaves 0, to one float32
    rounding (utils/general.py::expon_lr)."""
    jg, tg, _, _ = _models(use_feat_bank=True)
    for step in (1, 500, 12_345, 30_000):
        ja, jm = jg.learning_rates(jnp.asarray(step, jnp.float32))
        ta, tm = tg.learning_rates(step)
        for k, v in ta.items():
            np.testing.assert_allclose(v, float(getattr(ja, k)), rtol=1e-6,
                                       err_msg=f"{step} {k}")
        for k, v in tm.items():
            np.testing.assert_allclose(v, float(getattr(jm, k)), rtol=1e-6,
                                       err_msg=f"{step} {k}")
        assert ta["rotation"] == ta["opacity"] == 0.0


def test_create_from_points_matches_gssr_tpu_but_the_mlp_draw():
    """The same voxelised anchors, scales, capacity and shapes; the MLP
    comes from a torch generator, Linear's default bounds."""
    from gssr_tpu_torch.models.convert import scaffold_state_to_numpy
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussianConfig as TC
    from gssr_tpu_torch.models.scaffold import ScaffoldGaussians as TG
    from gssr_tpu.models.scaffold import ScaffoldGaussianConfig as JC
    from gssr_tpu.models.scaffold import ScaffoldGaussians as JG
    pts = np.random.default_rng(5).uniform(-1, 1, (400, 3))
    kw = dict(feat_dim=8, n_offsets=4, appearance_dim=4, voxel_size=0.2)
    js = JG(JC(**kw), num_cameras=3).create_from_points(pts)
    ts = TG(TC(**kw), num_cameras=3).create_from_points(pts, None, "cpu")
    leaves_j = jax.tree.leaves(js)
    leaves_t = scaffold_state_to_numpy(ts)
    assert [np.shape(a) for a in leaves_j] == [b.shape for b in leaves_t]
    for i in list(range(6)) + list(range(23, 77)):      # all but the MLP
        np.testing.assert_array_equal(leaves_t[i], np.asarray(leaves_j[i]),
                                      err_msg=f"leaf {i}")
    w = ts.mlp["op_w1"]
    bound = 1 / np.sqrt(w.shape[0])
    assert float(w.abs().max()) <= bound and float(w.std()) > bound / 4
    assert dataclasses.asdict(TC()).keys() <= set(
        f.name for f in dataclasses.fields(JC))
