"""Train a gaussian-splatting method on a COLMAP scene with the PyTorch/CUDA
port:

    python -m gssr_tpu_torch.train 3dgs --source-path /data/scene \
        --output-path ./out [--machine.device cpu]

Runs on the CUDA card unless `--machine.device cpu` is given; without a
card and without that flag it stops with an error.

    python -m gssr_tpu_torch.train <method> --trainer.load-config \
        <run>/config.yml [--machine.device cpu]

re-runs a saved config (the port's or gssr_tpu's) under a fresh run
directory, on the device this command names.

    python -m gssr_tpu_torch.train 3dgs --source-path S \
        --machine.parallel dp|band|gshard --machine.num-devices N \
        [--machine.device cpu]

trains on N ranks, one process per card (NCCL; on the CPU gloo), which
this command starts itself; under torchrun, or with the GSSR_COORDINATOR /
GSSR_NUM_PROCESSES / GSSR_PROCESS_ID environment, each launched process
is one rank instead (parallel/launch.py). Rank 0 writes the run.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from gssr_tpu_torch.configs.base import Config, load_config_yaml
from gssr_tpu_torch.configs.cli import parse_config
from gssr_tpu_torch.engine.trainer import Trainer
from gssr_tpu_torch.parallel import comm, launch


def main(config: Config) -> Optional[Trainer]:
    """Train the config's run. Returns the trainer, or None where this
    process started the ranks of a multi-device run itself."""
    if config.trainer.load_config:
        # re-run a saved config under a fresh timestamped run dir, on the
        # device this command names
        print(f"loading pre-set config from {config.trainer.load_config}")
        device = config.machine.device
        config = load_config_yaml(config.trainer.load_config)
        config.timestamp = "{timestamp}"
        config.machine.device = device
    if not config.source_path:
        raise SystemExit(
            "error: --source-path is required (a COLMAP scene directory)")
    config.machine.torch_device()           # fail early without a card
    config.set_timestamp()                  # before the ranks start: shared
    out = launch.run(config.machine, _train, (config,), train_rank)
    return None if isinstance(out, list) else out


def train_rank(config: Config) -> list:
    """One rank of a run that spawn started: its losses at the log
    points."""
    return [h[1] for h in _train(config).history]


def _train(config: Config) -> Trainer:
    random.seed(config.machine.seed)
    np.random.seed(config.machine.seed)
    torch.manual_seed(config.machine.seed)
    writes = comm.writes(config.machine.parallel)
    if writes:
        config.save_config()
    trainer = Trainer(config)
    trainer.setup()
    trainer.train()
    if writes:
        (config.get_base_dir() / "DONE").write_text(
            f"iterations={config.trainer.iterations}\n")
    trainer.sync()
    return trainer


if __name__ == "__main__":
    main(parse_config())
