"""The port's losses, optimizer, densification and serialization against
gssr_tpu, from identical carried-across state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(atol=1e-6, rtol=1e-5)


def _images(seed, h=40, w=36):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "ssim", "psnr"])
def test_losses_and_their_gradients(name):
    from gssr_tpu.ops import ssim as jm
    from gssr_tpu_torch.ops import ssim as tm
    a, b = _images(0)
    jv, jg = jax.value_and_grad(getattr(jm, name))(jnp.asarray(a),
                                                  jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tv = getattr(tm, name)(ta, torch.from_numpy(b))
    (tg,) = torch.autograd.grad(tv, ta)
    np.testing.assert_allclose(float(tv), float(jv), atol=1e-6, rtol=1e-5)
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                               atol=1e-5 * scale, rtol=1e-4)


def _models(capacity=256, extent=2.0, **cfg):
    from gssr_tpu.models.vanilla import VanillaGaussianConfig as JC
    from gssr_tpu.models.vanilla import VanillaGaussians as JG
    from gssr_tpu_torch.models.vanilla import VanillaGaussianConfig as TC
    from gssr_tpu_torch.models.vanilla import VanillaGaussians as TG
    return (JG(JC(capacity=capacity, **cfg), extent),
            TG(TC(capacity=capacity, **cfg), extent))


def _states(seed=0, n=40):
    """The same state in both packages: the reference's init, perturbed
    and with nonzero moments and statistics, carried across."""
    from gssr_tpu_torch.models.convert import state_from_numpy
    jg, tg = _models()
    rng = np.random.default_rng(seed)
    js = jg.create_from_points(rng.uniform(-1, 1, (n, 3)),
                               rng.uniform(0, 1, (n, 3)))
    leaves, treedef = jax.tree.flatten(js)
    leaves = [np.asarray(x) for x in leaves]
    for i in range(18):            # params and moments
        leaves[i] = (leaves[i] + rng.normal(0, 0.05, leaves[i].shape)
                     ).astype(np.float32)
        if 6 <= i < 18:
            leaves[i] = np.abs(leaves[i]) * (i >= 12) + leaves[i] * (i < 12)
    leaves[18] = np.asarray(7, np.int32)
    cap = leaves[0].shape[0]
    leaves[19] = rng.uniform(0, 30, cap).astype(np.float32)
    leaves[20] = rng.uniform(0, 0.01, cap).astype(np.float32)
    leaves[21] = rng.integers(0, 5, cap).astype(np.float32)
    js = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    return jg, tg, js, state_from_numpy(leaves, "cpu")


def _assert_state_close(js, ts, atol=1e-6, rtol=1e-5):
    from gssr_tpu_torch.models.convert import state_to_numpy
    for i, (a, b) in enumerate(zip(jax.tree.leaves(js), state_to_numpy(ts))):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if a.dtype == np.bool_ or a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
        else:
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                       err_msg=f"leaf {i}")


def test_state_round_trip_and_init():
    from gssr_tpu_torch.models.convert import state_to_numpy
    jg, tg, js, ts = _states()
    for a, b in zip(jax.tree.leaves(js), state_to_numpy(ts)):
        np.testing.assert_array_equal(b, np.asarray(a))
    rng = np.random.default_rng(5)
    pts, cols = rng.uniform(-1, 1, (60, 3)), rng.uniform(0, 1, (60, 3))
    _assert_state_close(jg.create_from_points(pts, cols),
                        tg.create_from_points(pts, cols, "cpu"))


def test_learning_rates_adam_and_stats():
    jg, tg, js, ts = _states(1)
    for step in (1, 500, 29_999):
        lj, lt = jg.learning_rates(step), tg.learning_rates(step)
        for k in lt:
            # both evaluate the schedule in float32; XLA's and PyTorch's
            # exp may round one ulp apart
            np.testing.assert_allclose(lt[k], float(getattr(lj, k)),
                                       rtol=3e-7, err_msg=f"{step} {k}")
    rng = np.random.default_rng(2)
    grads = [rng.normal(0, 1e-3, np.shape(x)).astype(np.float32)
             for x in js.params]
    lrs_j = jg.learning_rates(123)
    p_j, adam_j = jg.adam_step(js.params, type(js.params)(*map(
        jnp.asarray, grads)), js.adam, lrs_j)
    from gssr_tpu_torch.models.vanilla import PARAM_NAMES
    ts2 = tg.adam_step(ts, {k: torch.from_numpy(g)
                            for k, g in zip(PARAM_NAMES, grads)},
                       tg.learning_rates(123))
    _assert_state_close(js._replace(params=p_j, adam=adam_j), ts2)

    cap = ts.active.shape[0]
    radii = rng.integers(-1, 40, cap).astype(np.int32)
    m2d = rng.normal(0, 1e-5, (cap, 2)).astype(np.float32)
    sj = jg.update_stats(js.stats, jnp.asarray(radii), jnp.asarray(m2d),
                         jg.ndc_grad_scale(48, 32))
    st = tg.update_stats(ts.stats, torch.from_numpy(radii),
                         torch.from_numpy(m2d), tg.ndc_grad_scale(48, 32))
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(getattr(sj, k)),
                                   **TOL)
    _assert_state_close(jg.reset_opacity(js), tg.reset_opacity(ts))


@pytest.mark.parametrize("size_prune", [False, True])
def test_densify_and_prune_with_injected_noise(size_prune):
    jg, tg, js, ts = _states(3)
    key = jax.random.PRNGKey(11)
    # the reference draws its split noise from this key internally
    noise = np.asarray(jax.random.normal(key, (2, ts.active.shape[0], 3)))
    nj = jg.densify_and_prune(js, key, jnp.asarray(size_prune))
    nt = tg.densify_and_prune(ts, size_prune, noise=torch.from_numpy(noise))
    assert int(nt.n_active) != int(ts.n_active)       # something happened
    _assert_state_close(nj, nt)


def test_ply_written_by_the_port_loads_in_gssr_tpu(tmp_path):
    jg, tg, js, ts = _states(4)
    path = str(tmp_path / "g.ply")
    tg.save_ply(ts, path)
    back = jg.load_ply(path, capacity=ts.active.shape[0])
    active = ts.active.numpy()
    for k, v in ts.params.items():
        np.testing.assert_array_equal(np.asarray(getattr(back.params, k))[
            :int(ts.n_active)], v.numpy()[active], err_msg=k)
    # and the port reads its own file back
    again = tg.load_ply(path, "cpu", capacity=ts.active.shape[0])
    for k, v in again.params.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(getattr(back.params, k)))
