"""Train every tile of a partitioned scene, one after another:

    python -m gssr_tpu_torch.train_split octree-2dgs --source-path S \
        --output-path O [--machine.num-hosts N --machine.host-rank R] \
        [--retrain true] [--machine.device cpu] [any train flag]

S holds the tile_XXXX/ directories that `python -m
gssr_tpu_torch.split_scene` wrote. Tile t is trained when t % N == R, so
N processes (one per host or card) share the tiles; each tile's run is
O/<experiment>/tile_XXXX/<method>/<timestamp>/. A tile whose earlier run
of this method has a DONE marker is skipped unless --retrain true.
Runs on the CUDA card unless --machine.device cpu is given; without a
card and without that flag it stops with an error.
"""
from __future__ import annotations

import copy
import gc
import glob
import os
from typing import Callable, List, Optional, Tuple

import torch

from gssr_tpu_torch import train
from gssr_tpu_torch.configs.cli import parse_config


def main(argv: Optional[List[str]] = None,
         train_tile: Callable = train.main) -> Tuple[List[str], List[str]]:
    """Returns the tiles trained and the tiles skipped. `train_tile` trains
    one tile's config (train.main; a caller may wrap it to measure each
    tile); what it returns is dropped before the next tile starts."""
    config = parse_config(argv)
    if not config.source_path:
        raise SystemExit("error: --source-path is required (the directory "
                         "that holds the tile_* directories)")
    tiles = sorted(glob.glob(os.path.join(config.source_path, "tile_*")))
    if not tiles:
        raise SystemExit(f"error: no tile_* dirs under {config.source_path}")
    device = config.machine.torch_device()          # fail early without a card
    n_hosts = max(config.machine.num_hosts, 1)
    rank = config.machine.host_rank
    config.set_experiment_name()
    config.set_timestamp()

    trained, skipped = [], []
    for i, tile_dir in enumerate(tiles):
        if i % n_hosts != rank:
            continue
        tcfg = copy.deepcopy(config)
        tcfg.source_path = tile_dir
        tcfg.experiment_name = os.path.join(
            config.experiment_name, os.path.basename(tile_dir))
        done = glob.glob(os.path.join(
            config.output_path, tcfg.experiment_name,
            str(config.method_name), "*", "DONE"))
        if done and not config.retrain:
            print(f"=== skipping {tile_dir} (done: {done[-1]}; "
                  "--retrain true to force) ===")
            skipped.append(tile_dir)
            continue
        print(f"=== training {tile_dir} ({i + 1}/{len(tiles)}) ===")
        train_tile(tcfg)
        # the tile's trainer (scene, optimizer state, anchors) is gone:
        # free its memory before the next tile, so that the process's
        # peak is one tile's and not the sum
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        trained.append(tile_dir)
    print(f"trained {len(trained)} tiles (skipped {len(skipped)} done) "
          f"on host {rank}/{n_hosts}")
    return trained, skipped


if __name__ == "__main__":
    main()
