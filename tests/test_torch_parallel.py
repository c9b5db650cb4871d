"""Multi-device training in the port on two gloo ranks on the CPU
(parallel/launch.py::spawn, a FileStore under tmp_path), at 64 x 64 with a
few hundred gaussians: band and gaussian-sharded renders and gradients
against one device and gssr_tpu; dp, band and gshard train steps, and the
state after a densify, against gssr_tpu's shard_map steps on two devices
of the virtual CPU mesh (backend "reference", PGSR on its Pallas blend in
interpret mode; from the same initial state); the same steps against the
port's single-device step; and the state every rank holds after a
densify.

One module-scoped spawn runs every rank-side check
(tests/torch_parallel_ranks.py::checks) while this process runs
gssr_tpu's steps; the tests read both results.
Tolerances are the reference's: forward atol 1e-5 (rtol 1e-4); gradients
rtol 2e-3 with atol 2e-4 or, where larger, 2e-3 of the leaf's largest
magnitude, as gssr_tpu's tests/test_parallel.py::_grad_tree_close scales
it: the cross-rank sum reassociates each per-gaussian sum, and in band
mode the surfel map's rebase to band rows rounds differently, which moves
a gradient that is the difference of large terms by ~1e-6 of the leaf's
scale.
"""
import concurrent.futures
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_parallel_ranks as ranks  # noqa: E402

FWD = dict(atol=1e-5, rtol=1e-4)
BWD = dict(atol=2e-4, rtol=2e-3)


def assert_grads_close(got, want, name):
    """The gradient tolerance of the module docstring."""
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    atol = max(BWD["atol"], BWD["rtol"] * scale)
    np.testing.assert_allclose(got, want, atol=atol, rtol=BWD["rtol"],
                               err_msg=name)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from synthetic import write_synthetic_colmap_scene
    d = tmp_path_factory.mktemp("par_scene")
    write_synthetic_colmap_scene(str(d / "s64"), n_cams=4, n_pts=300,
                                 width=64, height=64)
    # 48 px: three tile rows, which two ranks cannot band
    write_synthetic_colmap_scene(str(d / "s48"), n_cams=4, n_pts=64,
                                 width=32, height=48)
    return str(d / "s64"), str(d / "s48"), str(d / "out")


def assert_leaves_close(got, want, what):
    """Two states' leaves in gssr_tpu's order: float leaves at the
    gradient tolerance (after one Adam step a parameter moves by about
    its learning rate times the sign of its gradient, its first moment is
    a tenth of the gradient), the others (active, counts) exactly."""
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        if np.issubdtype(b.dtype, np.floating):
            assert_grads_close(np.asarray(a, np.float32),
                               b.astype(np.float32), f"{what}, leaf {i}")
        else:
            np.testing.assert_array_equal(np.asarray(a).astype(b.dtype), b,
                                          err_msg=f"{what}, leaf {i}")


def j_scene(method, scene_dir, out_dir):
    """gssr_tpu's scene of `method` with the port's test options
    (torch_parallel_ranks.configure), on the reference backend (PGSR on
    its Pallas blend in interpret mode: the reference backend reads no
    abs screen gradient); the anchor decode takes every visible anchor,
    as the port's does."""
    from gssr_tpu.configs.methods import build_scene, get_method_config
    config = ranks.configure(get_method_config(method), scene_dir, out_dir,
                             **ranks.REF_SCENE.get(method, {}))
    config.scene.backend = "pallas" if method == "pgsr" else "reference"
    config.scene.instance_cap = 1 << 13
    g = config.scene.gaussians
    if hasattr(g, "visible_budget_factor"):
        config.scene.gaussians = dataclasses.replace(
            g, visible_budget_factor=1.0)
    return build_scene(config)


def j_leaves(state):
    import jax
    return [np.array(x) for x in jax.tree.leaves(state)]


@pytest.fixture(scope="module")
def given(scenes, tmp_path_factory):
    """Per method of REF_CASES, what the ranks take of gssr_tpu: its
    initial state's leaves, the octree's host attributes and the split
    noise of the 3dgs densify after step 2 (the scene key's first split:
    no step before it draws)."""
    import jax
    out = {}
    for method in sorted({m for m, _ in ranks.REF_CASES}):
        js = j_scene(method, scenes[0], str(tmp_path_factory.mktemp("j")))
        host, draws = None, {}
        jg = js.gaussians
        if hasattr(jg, "init_pos"):
            host = dict(levels=jg.levels, init_level=jg.init_level,
                        standard_dist=jg.standard_dist,
                        voxel_size=jg.voxel_size,
                        init_pos=np.asarray(jg.init_pos),
                        cam_infos=np.asarray(jg.cam_infos),
                        visible_threshold=jg.visible_threshold,
                        coarse_intervals=list(jg.coarse_intervals))
        if method == "3dgs":
            _, key = jax.random.split(js.key)
            cap = js.state.params.xyz.shape[0]
            draws["noise"] = np.array(jax.random.normal(key, (2, cap, 3)))
        out[method] = dict(leaves=j_leaves(js.state), host=host,
                           draws=draws, key=np.array(js.key))
    return out


def gssr_tpu_case(method, mode, scene_dir, out_dir, given):
    """ref_case of torch_parallel_ranks in gssr_tpu: its shard_map step on
    two devices of the virtual CPU mesh."""
    import jax
    import jax.numpy as jnp
    js = j_scene(method, scene_dir, out_dir)
    js.setup_parallel(mode, devices=jax.devices()[:2])
    picks = ranks.record_picks(js) if hasattr(js, "key_host_choice") else []
    state = jax.tree.unflatten(jax.tree.structure(js.state),
                               [jnp.asarray(x) for x in given["leaves"]])
    state, metrics = js.train_step(state, ranks.ref_cameras(js, mode, 1), 1)
    out = dict(step=j_leaves(state),
               metrics={k: float(v) for k, v in metrics.items()},
               picks=picks)
    if hasattr(js, "extra_stats"):
        out["extra"] = {k: np.array(v) for k, v in js.extra_stats.items()}
    if method in ranks.REF_DENSIFY:
        state, _ = js.train_step(state, ranks.ref_cameras(js, mode, 2), 2)
        # the noise the ranks were given is this densify's
        np.testing.assert_array_equal(np.array(js.key), given["key"])
        out["densified"] = j_leaves(js.densify(state, 2))
    return out


@pytest.fixture(scope="module")
def both(scenes, given, tmp_path_factory):
    """(the ranks' results, gssr_tpu's REF_CASES): the spawn runs in a
    thread while this process runs gssr_tpu's steps."""
    from gssr_tpu_torch.parallel.launch import spawn
    store = tmp_path_factory.mktemp("store")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(spawn, ranks.checks, 2, "gloo", "cpu",
                                str(store), (*scenes, given), timeout=900)
        refs = {(m, mode): gssr_tpu_case(
            m, mode, scenes[0], str(tmp_path_factory.mktemp("jcase")),
            given[m]) for m, mode in ranks.REF_CASES}
        out = ranks_run.result()
    assert [r["rank"] for r in out] == [0, 1]
    assert all(r["world"] == 2 for r in out)
    return out, refs


@pytest.fixture(scope="module")
def results(both):
    return both[0]


@pytest.mark.parametrize("method,mode", ranks.REF_CASES)
def test_a_step_equals_gssr_tpus_shard_map_step(both, method, mode):
    """The whole state after one step (parameters, Adam's moments, which
    hold the merged gradients, the statistics, the MLP), its metrics,
    PGSR's extra statistics and its neighbour draws (one per camera of
    the step, on every rank); dp on two cameras, one per rank."""
    results, refs = both
    ref = refs[(method, mode)]
    losses = sorted(k for k in ref["metrics"]
                    if k == "loss" or k.endswith("_loss"))
    assert ref["metrics"]["loss"] > 0 and len(losses) > 2
    if method == "pgsr":
        assert len(ref["picks"]) == (2 if mode == "dp" else 1)
    for r in results:
        got = r[f"ref {method} {mode}"]
        assert_leaves_close(got["step"], ref["step"], f"{method} {mode}")
        assert got["picks"] == ref["picks"]
        assert losses == sorted(k for k in got["metrics"]
                                if k == "loss" or k.endswith("_loss"))
        for k in losses:
            np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                       err_msg=k, **FWD)
        assert got["metrics"]["num_rendered"] == \
            ref["metrics"]["num_rendered"]
        for k, v in ref.get("extra", {}).items():
            assert_grads_close(got["extra"][k], v, f"extra {k}")


@pytest.mark.parametrize("method,mode", [
    c for c in ranks.REF_CASES if c[0] in ranks.REF_DENSIFY])
def test_the_state_after_a_densify_equals_gssr_tpus(both, method, mode):
    """Step 2 and the densify after it (3dgs: gssr_tpu's split noise;
    octree-2dgs: its anchor growing), on gssr_tpu's replicated or
    GSPMD-sharded state and the port's gathered one."""
    results, refs = both
    ref = refs[(method, mode)]["densified"]
    before = refs[(method, mode)]["step"]
    # the leaf n_active: the last of a vanilla state, before the octree's
    # level and extra_level in an anchor one
    n_active = -1 if method == "3dgs" else -3
    assert int(ref[n_active]) != int(before[n_active]), "nothing densified"
    for r in results:
        assert_leaves_close(r[f"ref {method} {mode}"]["densified"], ref,
                            f"{method} {mode} densified")


def test_band_render_matches_one_device_and_gssr_tpu(results):
    import jax
    import jax.numpy as jnp
    from gssr_tpu.cameras import Camera
    from gssr_tpu.parallel.sharded import build_band_render
    from gssr_tpu_torch.ops.rasterize import rasterize
    torch.set_num_threads(1)
    x = ranks.render_inputs()
    c = ranks.camera()
    t = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in x.items()}
    one = rasterize(t["means"], t["scales"], t["rots"], t["opac"],
                    c.arrays("cpu"), ranks.W, ranks.H, torch.zeros(3),
                    sh_coeffs=t["sh"], sh_degree=3).image.numpy()
    j = {k: jnp.asarray(v, jnp.float32) for k, v in x.items()}
    jcam = Camera(uid=0, colmap_id=0, image_name="band", R=c.R, T=c.T,
                  fovx=c.fovx, fovy=c.fovy, width=c.width, height=c.height)
    render_fn, _ = build_band_render(ranks.W, ranks.H, instance_cap=1 << 13,
                                     sh_degree=3, backend="reference",
                                     devices=jax.devices()[:2])
    ref = np.asarray(render_fn(j["means"], j["scales"], j["rots"], j["opac"],
                               j["sh"], jcam.arrays(), jnp.zeros(3)))
    assert np.abs(one).max() > 0.1
    for r in results:
        np.testing.assert_allclose(r["band_render"], one, **FWD)
        np.testing.assert_allclose(r["band_render"], ref, **FWD)


@pytest.mark.parametrize("kind", ["3dgs", "2dgs", "pgsr"])
def test_band_gradients_summed_equal_one_device(results, kind):
    """Each rank's gradient is its band's times the number of ranks
    (parallel/comm.py::gather_bands): their mean is the sum over the
    bands, the one-device gradient."""
    torch.set_num_threads(1)
    image, grads, n_rendered = ranks.render_grads(kind)
    for r in results:
        b_image, _, b_rendered = r[f"band_{kind}"]
        np.testing.assert_allclose(b_image, image, **FWD)
        assert b_rendered == n_rendered
    for name, g, g0, g1 in zip(("means", "scales", "rots", "opac", "sh"),
                               grads, results[0][f"band_{kind}"][1],
                               results[1][f"band_{kind}"][1]):
        assert np.abs(g0).max() > 0 and np.abs(g1).max() > 0, name
        assert_grads_close((g0 + g1) / 2, g, name)


@pytest.mark.parametrize("kind", ["3dgs", "2dgs"])
def test_gshard_gradient_slices_equal_one_device(results, kind):
    torch.set_num_threads(1)
    image, grads, n_rendered = ranks.render_grads(kind)
    n = ranks.N_GAUSS // 2
    for r in results:
        s_image, s_grads, s_rendered = r[f"gshard_{kind}"]
        np.testing.assert_allclose(s_image, image, **FWD)
        assert s_rendered == n_rendered
        for name, g, gs in zip(("means", "scales", "rots", "opac", "sh"),
                               grads, s_grads):
            assert_grads_close(gs, g[r["rank"] * n:(r["rank"] + 1) * n],
                               name)


@pytest.mark.parametrize("method,pos", [("3dgs", "params.xyz"),
                                        ("octree-2dgs", "anchors.anchor")])
def test_dp_with_one_camera_equals_a_single_device_step(results, method,
                                                        pos):
    ref = results[0][f"single_{method}"]
    for r in results:
        dp = r[f"dp_{method}"]
        np.testing.assert_allclose(dp["metrics"]["loss"],
                                   ref["metrics"]["loss"], **FWD)
        # the mean of two equal gradients is each of them
        for g_dp, g_ref in zip(dp["grads"], ref["grads"]):
            for k in g_ref:
                np.testing.assert_array_equal(g_dp[k], g_ref[k], err_msg=k)
        np.testing.assert_allclose(dp["state"][pos], ref["state"][pos],
                                   atol=1e-5)
        # each rank's statistics delta adds: the camera counts twice
        denom = "stats.denom" if method == "3dgs" else "stats.anchor_denom"
        assert ref["state"][denom].max() > 0
        np.testing.assert_allclose(dp["state"][denom],
                                   2 * ref["state"][denom], atol=1e-5)


def test_pgsr_band_two_camera_step_equals_one_device(results):
    ref = results[0]["single_pgsr_step"]
    assert "geo_loss" in ref["metrics"] and "ncc_loss" in ref["metrics"]
    for r in results:
        band = r["band_pgsr_step"]
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(band["metrics"][k], v, err_msg=k,
                                       **FWD)
        for k in ref["grads"][0]:
            assert_grads_close(band["grads"][0][k], ref["grads"][0][k], k)
        # the observe counts, band-partial, summed over the ranks
        np.testing.assert_array_equal(band["observe"][0], ref["observe"][0])
        assert ref["observe"][0].max() > 0


def test_octree_2dgs_gshard_step_equals_one_device(results):
    ref = results[0]["single_octree-2dgs"]
    r0, r1 = (r["gshard_octree-2dgs"] for r in results)
    # the ranks decode different numbers of visible anchors: the gather of
    # their neural gaussians is padded
    assert r0["n_visible"] != r1["n_visible"], (r0["n_visible"],
                                                r1["n_visible"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["metrics"]["loss"],
                                   ref["metrics"]["loss"], **FWD)
    anchors_ref, mlp_ref = ref["grads"]
    for k, g in anchors_ref.items():
        assert_grads_close(
            np.concatenate([r0["grads"][0][k], r1["grads"][0][k]]), g, k)
    for k, g in mlp_ref.items():
        # replicated, summed over the ranks
        for r in (r0, r1):
            assert_grads_close(r["grads"][1][k], g, k)


@pytest.mark.parametrize("mode", ["band", "gshard"])
def test_the_scaling_loss_reaches_each_anchor_once(results, mode):
    """Band: the term is replicated and each rank differentiates it
    whole, so the mean over the ranks that merges band gradients counts
    it once. gshard: its masked mean takes the sum and count over the
    ranks, so each rank's gradient is its rows of the one-device
    gradient."""
    one = results[0]["scaling_grads"]["none"]
    got = [r["scaling_grads"][mode] for r in results]
    assert np.abs(one).max() > 0
    # the gradients are ~1e-6: compare them bit for bit (the same
    # arithmetic), not at the forward tolerance, which they sit under
    both = (got[0] + got[1]) / 2 if mode == "band" else np.concatenate(got)
    np.testing.assert_array_equal(both, one)


def test_octree_2dgs_band_step_equals_one_device(results):
    """The anchors' and the MLP's gradients merged over the bands; the
    scaling loss, which reaches them outside the bands, counted once."""
    ref = results[0]["single_octree-2dgs"]
    assert ref["metrics"]["scaling_loss"] > 0
    for r in results:
        band = r["band_octree-2dgs"]
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(band["metrics"][k], v, err_msg=k,
                                       **FWD)
        for got, want in zip(band["grads"], ref["grads"]):
            for k in want:
                assert_grads_close(got[k], want[k], k)


@pytest.mark.parametrize("mode", ["dp", "band", "gshard"])
def test_replicated_state_is_the_same_on_every_rank_after_a_densify(
        results, mode):
    (n0, a), (_, b) = (r[f"densified_{mode}"] for r in results)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["n_active"]) != n0, "the densify pass changed nothing"


def test_band_refuses_tile_rows_that_do_not_divide(results):
    for r in results:
        assert "3 tile rows" in r["band_refused"], r["band_refused"]


@pytest.mark.parametrize("method", ["pgsr", "scaffold-pgsr"])
def test_gshard_refuses_the_planar_methods(scenes, tmp_path, method):
    torch.set_num_threads(1)
    scene = ranks.build(method, scenes[0], str(tmp_path))
    with pytest.raises(NotImplementedError, match="gshard"):
        scene.setup_parallel("gshard")
