"""The port's PGSR gaussian model against gssr_tpu's, from identical
carried-across state: the statistics with the abs channel and the observe
gate, the budget quantile, and densify_and_prune with injected noise where
the point budget's quantile re-selection fires, for the clone and split
channels and for the abs channel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(atol=1e-6, rtol=1e-5)
CAP, N = 128, 120


def _models(**cfg):
    from gssr_tpu.models.pgsr import PGSRGaussianConfig as JC
    from gssr_tpu.models.pgsr import PGSRGaussians as JG
    from gssr_tpu_torch.models.pgsr import PGSRGaussianConfig as TC
    from gssr_tpu_torch.models.pgsr import PGSRGaussians as TG
    return JG(JC(capacity=CAP, **cfg), 2.0), TG(TC(capacity=CAP, **cfg), 2.0)


def _states(seed, abs_case, **cfg):
    """The same state and extra stats in both packages: half the active
    gaussians below percent_dense * extent (clone candidates), half above
    (split candidates), gradients straddling the thresholds, and in the
    abs case a group of large, not-hot gaussians with abs gradients above
    theirs."""
    from gssr_tpu_torch.models.convert import state_from_numpy
    jg, tg = _models(**cfg)
    rng = np.random.default_rng(seed)
    js = jg.create_from_points(rng.uniform(-1, 1, (N, 3)),
                               rng.uniform(0, 1, (N, 3)))
    leaves, treedef = jax.tree.flatten(js)
    leaves = [np.array(x) for x in leaves]
    for i in range(18):
        if i != 3:
            leaves[i] = (leaves[i] + rng.normal(0, 0.05, leaves[i].shape)
                         ).astype(np.float32)
        if 12 <= i < 18:
            leaves[i] = np.abs(leaves[i])
    scale = np.where(np.arange(CAP) < N // 2, 0.001, 0.05)
    leaves[3] = np.log(scale[:, None] * rng.uniform(0.8, 1.0, (CAP, 3))
                       ).astype(np.float32)
    leaves[18] = np.asarray(7, np.int32)
    active = leaves[22]
    leaves[19] = rng.uniform(0, 30, CAP).astype(np.float32)
    denom = rng.integers(1, 5, CAP).astype(np.float32)
    leaves[20] = (rng.uniform(0, 0.0004, CAP) * denom).astype(np.float32)
    leaves[21] = denom
    g_abs = rng.uniform(0, 0.0006, CAP)
    if abs_case:
        # fewer hot gaussians, and large cold ones with big abs gradients
        leaves[20] = (leaves[20] * (rng.uniform(0, 1, CAP) < 0.3)
                      ).astype(np.float32)
        big_cold = (np.arange(CAP) >= N // 2) & (leaves[20] == 0) & active
        g_abs = np.where(big_cold, rng.uniform(0.0009, 0.003, CAP), g_abs)
        leaves[19] = np.where(big_cold, 25.0, leaves[19]).astype(np.float32)
    d_abs = rng.integers(1, 4, CAP).astype(np.float32)
    extra = {"grad_accum_abs": (g_abs * d_abs).astype(np.float32),
             "denom_abs": d_abs,
             "max_weight": rng.uniform(0, 1, CAP).astype(np.float32)}
    js = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    return (jg, tg, js, state_from_numpy(leaves, "cpu"),
            {k: jnp.asarray(v) for k, v in extra.items()},
            {k: torch.from_numpy(v) for k, v in extra.items()})


def _assert_state_close(js, ts):
    from gssr_tpu_torch.models.convert import state_to_numpy
    for i, (a, b) in enumerate(zip(jax.tree.leaves(js), state_to_numpy(ts))):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if a.dtype == np.bool_ or a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(b, a, err_msg=f"leaf {i}", **TOL)


@pytest.mark.parametrize("n,q", [(128, 0.9583333), (1000, 0.5), (7, 1.0),
                                 (300, 0.0), (129, 0.3137)])
def test_quantile_matches_jnp_quantile(n, q):
    from gssr_tpu_torch.models.pgsr import quantile_linear
    rng = np.random.default_rng(n)
    x = rng.uniform(0, 1, n).astype(np.float32)
    x[rng.uniform(0, 1, n) < 0.6] = 0.0                     # many ties
    q32 = np.float32(q)
    a = np.asarray(jnp.quantile(jnp.asarray(x), jnp.asarray(q32)))
    b = quantile_linear(torch.from_numpy(x), torch.tensor(q32))
    np.testing.assert_array_equal(b.numpy(), a)


def test_update_stats_pgsr_matches():
    jg, tg, js, ts, je, te = _states(0, abs_case=False)
    rng = np.random.default_rng(1)
    radii = rng.integers(-1, 40, CAP).astype(np.int32)
    m2d = rng.normal(0, 1e-5, (CAP, 2)).astype(np.float32)
    m2d_abs = np.abs(rng.normal(0, 1e-5, (CAP, 2))).astype(np.float32)
    obs = rng.integers(0, 3, CAP).astype(np.float32)
    sj, ej = jg.update_stats_pgsr(js.stats, je, jnp.asarray(radii),
                                  jnp.asarray(m2d), jnp.asarray(m2d_abs),
                                  jnp.asarray(obs), jg.ndc_grad_scale(48, 32))
    st, et = tg.update_stats_pgsr(ts.stats, te, *map(torch.from_numpy, (
        radii, m2d, m2d_abs, obs)), tg.ndc_grad_scale(48, 32))
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(getattr(sj, k)),
                                   err_msg=k, **TOL)
    for k in et:
        np.testing.assert_allclose(et[k].numpy(), np.asarray(ej[k]),
                                   err_msg=k, **TOL)
    # the radius max moves only where the gaussian was observed
    moved = st["max_radii2d"].numpy() != ts.stats["max_radii2d"].numpy()
    assert moved.any() and (obs[moved] > 0).all()


@pytest.mark.parametrize("case,size_prune,cfg", [
    ("budget", False, dict(max_all_points=126)),
    ("abs", True, dict(max_all_points=200, max_abs_split_points=4)),
])
def test_densify_and_prune_with_injected_noise(case, size_prune, cfg):
    from gssr_tpu_torch.models.pgsr import PGSRGaussians
    jg, tg, js, ts, je, te = _states(3, abs_case=case == "abs", **cfg)
    key = jax.random.PRNGKey(11)
    # the reference draws the clone's and each child's noise from the
    # three keys it splits from this one
    noise = np.stack([np.asarray(jax.random.normal(k, (CAP, 3)))
                      for k in jax.random.split(key, 3)])
    nj, ej = jg.densify_and_prune(js, key, jnp.asarray(size_prune),
                                  extra=je)
    nt, et = tg.densify_and_prune(ts, size_prune, te,
                                  noise=torch.from_numpy(noise))
    _assert_state_close(nj, nt)
    for k in et:
        assert not et[k].any() and not np.asarray(ej[k]).any()

    # the budget's quantile re-selection changed the selection it was
    # given, so the comparison above held it, not the plain thresholds
    c = tg.config
    grads = ts.stats["grad_accum"] / ts.stats["denom"]
    small = tg.get_scaling(ts.params).amax(-1) <= c.percent_dense * 2.0
    hot = ts.active & (grads >= c.densify_grad_threshold)
    n0 = ts.n_active
    if case == "budget":
        sels = [(hot & small, grads, c.max_all_points),
                (hot & ~small, grads, c.max_all_points)]
    else:
        g_abs = te["grad_accum_abs"] / te["denom_abs"]
        gate = (ts.active & ~small & ~(hot & ~small)
                & (ts.stats["max_radii2d"] > c.abs_split_radii2D_threshold))
        want_split = int((hot & ~small).sum())
        limit = min(max(c.max_all_points - int(n0) - want_split, 0),
                    c.max_abs_split_points)
        sels = [(gate & (g_abs >= c.densify_abs_grad_threshold), g_abs,
                 int(n0) + limit)]
    for sel, g, budget in sels:
        assert int(n0) + int(sel.sum()) > budget
        kept = PGSRGaussians._budget_reselect(sel, g, n0, budget)
        assert 0 < int(kept.sum()) < int(sel.sum())
    assert int(nt.n_active) != int(ts.n_active)
