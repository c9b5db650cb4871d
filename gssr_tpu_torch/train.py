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
"""
from __future__ import annotations

import random

import numpy as np
import torch

from gssr_tpu_torch.configs.base import Config, load_config_yaml
from gssr_tpu_torch.configs.cli import parse_config
from gssr_tpu_torch.engine.trainer import Trainer


def main(config: Config) -> Trainer:
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
    config.machine.torch_device()          # fail early without a card
    config.set_timestamp()
    random.seed(config.machine.seed)
    np.random.seed(config.machine.seed)
    torch.manual_seed(config.machine.seed)
    config.save_config()
    trainer = Trainer(config)
    trainer.setup()
    trainer.train()
    (config.get_base_dir() / "DONE").write_text(
        f"iterations={config.trainer.iterations}\n")
    return trainer


if __name__ == "__main__":
    main(parse_config())
