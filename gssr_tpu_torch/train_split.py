"""Train every tile of a partitioned scene, one after another:

    python -m gssr_tpu_torch.train_split octree-2dgs --source-path S \
        --output-path O [--machine.num-hosts N --machine.host-rank R] \
        [--retrain true] [--machine.device cpu] [any train flag]

S holds the tile_XXXX/ directories that `python -m
gssr_tpu_torch.split_scene` wrote. Tile t is trained when t % N == R, so
N processes (one per host or card) share the tiles; under torchrun or
the GSSR_* environment of parallel/launch.py, N and R are the group's
world size and rank. Each tile's run is
O/<experiment>/tile_XXXX/<method>/<timestamp>/. A tile whose earlier run
of this method has a DONE marker is skipped unless --retrain true.
Runs on the CUDA card unless --machine.device cpu is given; without a
card and without that flag it stops with an error.

    python -m gssr_tpu_torch.train_split octree-2dgs --source-path S \
        --machine.parallel band|gshard|dp --machine.num-devices N \
        [--machine.num-hosts H --machine.host-rank R]

trains every tile of this host over N ranks, one tile after another, as
gssr_tpu trains each tile over a host's devices. The ranks are started
once for the whole sweep (parallel/launch.py::run: spawned by this
command, or launched by torchrun or the GSSR_* environment, one process
each); every rank trains every tile, rank 0 writes each tile's run, and
rank 0's DONE check decides the skip for all. The tiles stripe over hosts
by the --machine.num-hosts / --machine.host-rank flags only, one group a
host: a launcher's group of more processes than --machine.num-devices
(a group spanning hosts that train different tiles) stops with an error.

    python -m gssr_tpu_torch.train_split METHOD --trainer.load-config \
        <run>/config.yml [--source-path S] [--machine.device cpu]

trains the tiles with a saved config (the port's or gssr_tpu's, its
`parallel` mode included): of S (else of the config's source path), on
the device this command names.
"""
from __future__ import annotations

import copy
import gc
import glob
import os
from typing import Callable, List, Optional, Tuple

import torch

from gssr_tpu_torch import train
from gssr_tpu_torch.configs.base import Config, load_config_yaml
from gssr_tpu_torch.configs.cli import parse_config
from gssr_tpu_torch.parallel import comm, launch


def main(argv: Optional[List[str]] = None,
         train_tile: Callable = train.main) -> Tuple[List[str], List[str]]:
    """Returns the tiles trained and the tiles skipped (where this
    process started the ranks itself, rank 0's). `train_tile` trains one
    tile's config (train.main; a caller may wrap it to measure each
    tile); what it returns is dropped before the next tile starts. Where
    this process spawns the ranks, each rank calls it (it must pickle)."""
    config = load_tile_config(parse_config(argv))
    tiles = sorted(glob.glob(os.path.join(config.source_path, "tile_*")))
    if not tiles:
        raise SystemExit(f"error: no tile_* dirs under {config.source_path}")
    config.machine.torch_device()           # fail early without a card
    config.set_experiment_name()
    config.set_timestamp()                  # before the ranks start: shared
    out = launch.run(config.machine, sweep, (config, tiles, train_tile))
    return out[0] if isinstance(out, list) else out


def load_tile_config(config: Config) -> Config:
    """The sweep's config: the command's, or with --trainer.load-config
    the saved one under a fresh timestamp, with this command's device and
    (where given) source path."""
    if config.trainer.load_config:
        print(f"loading pre-set config from {config.trainer.load_config}")
        cli = config
        config = load_config_yaml(cli.trainer.load_config)
        config.timestamp = "{timestamp}"
        config.trainer.load_config = None     # the tiles do not reload it
        config.machine.device = cli.machine.device
        if cli.source_path:
            config.source_path = cli.source_path
            config.experiment_name = None
    if not config.source_path:
        raise SystemExit("error: --source-path is required (the directory "
                         "that holds the tile_* directories)")
    return config


def sweep(config: Config, tiles: List[str], train_tile: Callable
          ) -> Tuple[List[str], List[str]]:
    """This process's part of the sweep: every tile of this host, in the
    group that is up (machine.parallel set), or the tiles striped over the
    group's ranks or the host flags (single device)."""
    m = config.machine
    multi = m.parallel != "none"
    if multi:
        if m.num_devices and comm.world() > m.num_devices:
            raise SystemExit(
                f"error: the group spans {comm.world()} processes but "
                f"--machine.num-devices is {m.num_devices}: train_split "
                "trains each tile over one host's group and stripes tiles "
                "over hosts by --machine.num-hosts / --machine.host-rank; a "
                "group across hosts that train different tiles is not "
                "supported (gssr_tpu takes the global device list too)")
        # a launcher's processes each set their own clock: rank 0's wins
        config.timestamp = comm.broadcast_object(config.timestamp)
    say = print if comm.writes(m.parallel) else (lambda *a: None)
    device = m.torch_device()
    n_hosts = max(m.num_hosts, 1)
    host = m.host_rank
    trained, skipped = [], []
    for i, tile_dir in enumerate(tiles):
        if i % n_hosts != host:
            continue
        tcfg = copy.deepcopy(config)
        tcfg.source_path = tile_dir
        tcfg.experiment_name = os.path.join(
            config.experiment_name, os.path.basename(tile_dir))
        done = glob.glob(os.path.join(
            config.output_path, tcfg.experiment_name,
            str(config.method_name), "*", "DONE"))
        if multi:
            # one decision for every rank: a rank that skipped a tile
            # another trains would leave the collectives waiting
            done = comm.broadcast_object(done)
        if done and not config.retrain:
            say(f"=== skipping {tile_dir} (done: {done[-1]}; "
                "--retrain true to force) ===")
            skipped.append(tile_dir)
            continue
        say(f"=== training {tile_dir} ({i + 1}/{len(tiles)}) ===")
        train_tile(tcfg)
        if multi:
            # every rank is done with the tile (rank 0 has written it)
            # before the next starts
            comm.barrier()
        # the tile's trainer (scene, optimizer state, anchors) is gone:
        # free its memory before the next tile, so that the process's
        # peak is one tile's and not the sum
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        trained.append(tile_dir)
    say(f"trained {len(trained)} tiles (skipped {len(skipped)} done) "
        f"on host {host}/{n_hosts}"
        + (f", each over {comm.world()} ranks ({m.parallel})" if multi
           else ""))
    return trained, skipped


if __name__ == "__main__":
    main()
