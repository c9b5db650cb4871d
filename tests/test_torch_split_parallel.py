"""`python -m gssr_tpu_torch.train_split` over several devices per tile
(`--machine.parallel band|gshard`) on two gloo ranks: every rank trains
every tile of its host, one after another, in one group started once for
the sweep; rank 0 writes each tile's run; rank 0's DONE check decides the
skip for every rank; the tiles stripe over hosts by the host flags only;
a group of more processes than --machine.num-devices stops.

Each tile's final state is held against a one-device train_split tile at
the gradient tolerance of tests/test_torch_parallel.py (rtol 2e-3, atol
2e-4 or, where larger, 2e-3 of the leaf's largest magnitude; integer
leaves exactly): the band merge reassociates each per-anchor gradient
sum, and Adam turns a near-zero gradient's rounding into a step of its
learning rate. A 32 x 32 scene split into two tiles, 4 steps a tile."""
import glob
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import torch_parallel_ranks as ranks  # noqa: E402

STEPS = 4
BWD = dict(atol=2e-4, rtol=2e-3)


def _args(split, out, steps=STEPS):
    return ["octree-2dgs", "--source-path", split, "--output-path", out,
            "--machine.device", "cpu", "--trainer.iterations", str(steps),
            "--trainer.test-iterations", str(steps),
            "--trainer.save-iterations", str(steps),
            "--trainer.log-interval", "1", "--scene.gaussians.levels", "3"]


def _parallel(mode, n=2):
    return ["--machine.parallel", mode, "--machine.num-devices", str(n)]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A two-tile split of a synthetic scene, and each tile's final state
    and losses from a one-device train_split."""
    import torch
    from synthetic import write_synthetic_colmap_scene

    from gssr_tpu_torch import split_scene, train, train_split
    root = tmp_path_factory.mktemp("split_par")
    write_synthetic_colmap_scene(str(root / "scene"), n_cams=10, n_pts=128,
                                 width=32, height=32)
    tiles = split_scene.main(["--source-path", str(root / "scene"),
                              "--num-col", "2", "--num-row", "1",
                              "--visibility-threshold", "0.0"])
    assert len(tiles) == 2
    one = {}

    def tile(config):
        trainer = train.main(config)
        scene = trainer.scene
        one[os.path.basename(config.source_path)] = dict(
            leaves=scene.state_to_numpy(scene.state),
            losses=[h[1] for h in trainer.history])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # as each rank
    try:
        trained, _ = train_split.main(_args(str(root / "scene"),
                                            str(root / "one")),
                                      train_tile=tile)
    finally:
        torch.set_num_threads(threads)
    assert trained == tiles
    return str(root / "scene"), tiles, one


def _spawn(fn, args, store):
    from gssr_tpu_torch.parallel.launch import spawn
    store.mkdir()
    return spawn(fn, 2, "gloo", "cpu", str(store), args, timeout=600)


def _runs(out, name):
    """Per tile, the run directories that hold `name`."""
    found = {}
    for p in glob.glob(os.path.join(out, "*", "tile_*", "octree-2dgs", "*",
                                    name)):
        tile = p.split(os.sep)[-4]
        found.setdefault(tile, []).append(os.path.dirname(p))
    return found


def assert_leaves_close(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        if np.issubdtype(b.dtype, np.floating):
            assert a.shape == b.shape, (what, i)
            scale = float(np.abs(b).max()) if b.size else 0.0
            np.testing.assert_allclose(
                a, b, rtol=BWD["rtol"],
                atol=max(BWD["atol"], BWD["rtol"] * scale),
                err_msg=f"{what}, leaf {i}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}, leaf {i}")


@pytest.mark.parametrize("mode", ["band", "gshard"])
def test_every_rank_trains_every_tile_and_rank_0_writes_each_once(
        split, tmp_path, mode):
    scene, tiles, one = split
    out = str(tmp_path / "out")
    argv = _args(scene, out) + _parallel(mode)
    res = _spawn(ranks.split_sweep, (argv,), tmp_path / "s1")
    names = [os.path.basename(t) for t in tiles]
    for r in res:
        assert (r["trained"], r["skipped"]) == (tiles, [])
        assert sorted(r["tiles"]) == names
        for name in names:
            got, want = r["tiles"][name], one[name]
            assert_leaves_close(got["leaves"], want["leaves"],
                                f"rank {r['rank']} {name}")
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=1e-5, atol=1e-6)
    # rank 0 alone wrote each tile's run: one directory, one DONE
    for name in ("config.yml", "DONE"):
        found = _runs(out, name)
        assert sorted(found) == names and \
            all(len(v) == 1 for v in found.values()), (name, found)
    from gssr_tpu_torch.configs.base import load_config_yaml
    for run in _runs(out, "config.yml").values():
        m = load_config_yaml(os.path.join(run[0], "config.yml")).machine
        assert (m.parallel, m.num_devices) == (mode, 2)
        # the group's rank is no host
        assert (m.num_hosts, m.host_rank) == (1, 0)

    # again: rank 0's DONE check skips both tiles on both ranks
    res = _spawn(ranks.split_sweep, (argv,), tmp_path / "s2")
    for r in res:
        assert (r["trained"], r["skipped"], r["tiles"]) == ([], tiles, {})
    assert all(len(v) == 1 for v in _runs(out, "DONE").values())


def test_a_gssr_tpu_config_with_band_trains_its_tiles(split, tmp_path,
                                                      capfd):
    """A config.yml that gssr_tpu wrote, with `parallel: band` over two
    devices, through --trainer.load-config: this process starts the two
    ranks itself (parallel/launch.py::run)."""
    import dataclasses

    from gssr_tpu.configs.base import save_config_yaml
    from gssr_tpu.configs.methods import get_method_config

    from gssr_tpu_torch import train_split
    scene, tiles, _ = split
    config = get_method_config("octree-2dgs")
    config.source_path = scene
    config.output_path = str(tmp_path / "out")
    config.machine.parallel, config.machine.num_devices = "band", 2
    config.scene.gaussians = dataclasses.replace(config.scene.gaussians,
                                                 levels=3)
    t = config.trainer
    t.iterations, t.log_interval = 2, 1
    t.test_iterations, t.save_iterations = [2], [2]
    path = tmp_path / "config.yml"
    save_config_yaml(config, path)
    trained, skipped = train_split.main(
        ["octree-2dgs", "--trainer.load-config", str(path),
         "--machine.device", "cpu"])
    assert (trained, skipped) == (tiles, [])
    out = capfd.readouterr().out
    assert out.count("multi-device: mode=band over 2 ranks, backend "
                     "gloo") == 2, out
    assert "each over 2 ranks (band)" in out
    found = _runs(str(tmp_path / "out"), "DONE")
    assert sorted(found) == [os.path.basename(t) for t in tiles]
    assert all(len(v) == 1 for v in found.values())


def test_hosts_stripe_the_tiles_and_each_group_trains_its_own(split,
                                                              tmp_path):
    """Host 1 of 2 trains the odd tiles, on both of its ranks; its runs
    record the host flags, not the group's ranks."""
    scene, tiles, one = split
    out = str(tmp_path / "out")
    argv = _args(scene, out, steps=2) + _parallel("band") + [
        "--machine.num-hosts", "2", "--machine.host-rank", "1"]
    res = _spawn(ranks.split_sweep, (argv,), tmp_path / "s")
    for r in res:
        assert (r["trained"], r["skipped"]) == (tiles[1::2], [])
    found = _runs(out, "config.yml")
    assert sorted(found) == ["tile_0001"] and len(found["tile_0001"]) == 1
    from gssr_tpu_torch.configs.base import load_config_yaml
    m = load_config_yaml(os.path.join(found["tile_0001"][0],
                                      "config.yml")).machine
    assert (m.num_hosts, m.host_rank, m.parallel) == (2, 1, "band")


def test_a_group_larger_than_num_devices_stops(split, tmp_path):
    """A launcher's group of two processes for one device a tile: gssr_tpu
    cannot run a group across hosts that train different tiles either."""
    scene, _, _ = split
    argv = _args(scene, str(tmp_path / "out")) + _parallel("band", n=1)
    with pytest.raises(RuntimeError, match="the group spans 2 processes "
                       "but --machine.num-devices is 1"):
        _spawn(ranks.split_sweep, (argv,), tmp_path / "s")
    assert not os.path.exists(tmp_path / "out")
