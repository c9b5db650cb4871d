"""Typed dataclass config tree (port of gssr_tpu/configs/base.py).

Same shape and output-dir layout as the reference. Configs serialize as
plain YAML data (dict tree + class names) and are rebuilt through the
class registry of configs/methods.py. The multi-device fields
(`parallel`, `num_devices`, `dist_init`) wait for the scale-out slice;
`machine.device` picks the torch device.

`load_config_yaml` also reads a config.yml that gssr_tpu wrote. The
fields the port has no counterpart for (FOREIGN_FIELDS) are dropped with
one printed note each, and a value of one that would change what the
port computes (several devices) raises, naming the field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import List, Optional

import torch
import yaml


@dataclass
class MachineConfig:
    seed: int = 42
    # train_split trains the tiles t with t % num_hosts == host_rank
    num_hosts: int = 1
    host_rank: int = 0
    # "cuda" (the card; raises if there is none) or "cpu"
    device: str = "cuda"

    def torch_device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "machine.device is 'cuda' but no CUDA device is available; "
                "pass --machine.device cpu to run on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r}")
        return dev


@dataclass
class TrainerConfig:
    iterations: int = 30_000
    test_iterations: List[int] = field(default_factory=lambda: [30_000])
    save_iterations: List[int] = field(default_factory=lambda: [30_000])
    relative_gaussian_dir: str = "point_cloud/"
    checkpoint_iterations: List[int] = field(default_factory=list)
    relative_ckpt_dir: str = "chkpnt/"
    save_only_latest_checkpoint: bool = False
    load_ckpt_dir: Optional[str] = None
    load_ckpt_step: Optional[int] = None
    load_gaussian_dir: Optional[str] = None
    load_gaussian_step: Optional[int] = None
    load_config: Optional[str] = None
    log_interval: int = 10
    # a torch.profiler window from step profile_steps[0] to the end of
    # step profile_steps[1], its trace written into profile_dir
    profile_dir: Optional[str] = None
    profile_steps: List[int] = field(default_factory=lambda: [100, 110])


@dataclass
class PartitionConfig:
    """The VastGaussian partitioner's settings. As in gssr_tpu, nothing
    reads them (split_scene takes its own flags); they round-trip."""
    need_partition: bool = True
    num_col: int = 4
    num_row: int = 1
    extend_ratio: float = 0.1
    visibility_threshold: float = 0.5
    config_of_tiles: List[str] = field(default_factory=list)


@dataclass
class DataLoaderConfig:
    shuffle: bool = True
    llffhold: int = 8
    resolution_scales: List[float] = field(default_factory=lambda: [1.0])
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    # load GT frames on demand through a bounded LRU (dataio.LazyImage)
    lazy_images: bool = False
    image_cache_frames: int = 256


@dataclass
class Config:
    source_path: Optional[str] = None
    output_path: str = "./output"
    method_name: Optional[str] = None
    experiment_name: Optional[str] = None
    timestamp: str = "{timestamp}"
    eval: bool = False
    # train_split: train again the tiles whose earlier run has a DONE marker
    retrain: bool = False

    machine: MachineConfig = field(default_factory=MachineConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    scene: object = None          # method-specific SceneConfig
    partitioner: PartitionConfig = field(default_factory=PartitionConfig)

    # "tensorboard": scalars through tensorboardX into
    # <run>/relative_log_dir, when it imports; anything else: none
    writer: str = "tensorboard"
    relative_log_dir: str = "logs"

    def set_experiment_name(self):
        if self.experiment_name is None:
            self.experiment_name = str(self.source_path).rstrip("/").split(
                "/")[-1]

    def set_timestamp(self):
        if self.timestamp == "{timestamp}":
            self.timestamp = datetime.now().strftime("%Y-%m-%d_%H%M%S")

    def get_base_dir(self) -> Path:
        assert self.method_name is not None, "method name not set"
        self.set_experiment_name()
        return Path(self.output_path) / self.experiment_name / \
            self.method_name / self.timestamp

    def get_gaussian_dir(self) -> Path:
        return self.get_base_dir() / self.trainer.relative_gaussian_dir

    def get_checkpoint_dir(self) -> Path:
        return self.get_base_dir() / self.trainer.relative_ckpt_dir

    def save_config(self):
        d = self.get_base_dir()
        d.mkdir(parents=True, exist_ok=True)
        save_config_yaml(self, d / "config.yml")


def _to_plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": type(obj).__name__,
                **{f.name: _to_plain(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


def save_config_yaml(config: Config, path):
    with open(path, "w") as f:
        yaml.safe_dump(_to_plain(config), f, sort_keys=False)


# Fields of gssr_tpu's config classes that the port has no counterpart
# for: class name -> {field: the values under which the port computes what
# gssr_tpu computes, or None where no value changes it}. scan_block (K
# steps per XLA dispatch, the same steps) and the scene's instance_cap
# (the port sizes the instance buffer exactly per render) and blend
# backend (both compute the same blend) change no result of a
# single-device run, nor does the scaffold model's
# visible_budget_factor (the port sizes the visible-anchor decode exactly
# per step; the reference grows its budget whenever it overflows).
_SCENE_FIELDS = {"instance_cap": None, "backend": ("pallas", "reference")}
FOREIGN_FIELDS = {
    "MachineConfig": {"parallel": ("none",), "num_devices": (0, 1),
                      "dist_init": (False,)},
    "TrainerConfig": {"scan_block": None},
    "VanillaSceneConfig": _SCENE_FIELDS,
    "TwoDGSSceneConfig": _SCENE_FIELDS,
    "PGSRSceneConfig": _SCENE_FIELDS,
    "ScaffoldSceneConfig": _SCENE_FIELDS,
    "OctreeSceneConfig": _SCENE_FIELDS,
    "Scaffold2DGSSceneConfig": _SCENE_FIELDS,
    "Octree2DGSSceneConfig": _SCENE_FIELDS,
    "ScaffoldPGSRSceneConfig": _SCENE_FIELDS,
    "OctreePGSRSceneConfig": _SCENE_FIELDS,
    "ScaffoldGaussianConfig": {"visible_budget_factor": None},
    "OctreeGaussianConfig": {"visible_budget_factor": None},
}


def _drop_foreign(name: str, node: dict) -> dict:
    """The fields of a `name` node that the port's class takes: each field
    of FOREIGN_FIELDS[name] is dropped with a printed note, or raises
    where its value would change what the port computes."""
    kept = {}
    for k, v in node.items():
        allowed = FOREIGN_FIELDS.get(name, {}).get(k, ...)
        if allowed is ...:
            kept[k] = v
            continue
        if allowed is not None and v not in allowed:
            raise ValueError(
                f"config field {name}.{k} = {v!r} is not supported by "
                f"gssr_tpu_torch (single device only; it takes "
                f"{', '.join(map(repr, allowed))})")
        print(f"config: dropped gssr_tpu field {name}.{k} "
              f"(no counterpart in gssr_tpu_torch)")
    return kept


def load_config_yaml(path) -> Config:
    """Rebuild the typed config tree from plain YAML via the registry; a
    config.yml of gssr_tpu loses its FOREIGN_FIELDS on the way."""
    from gssr_tpu_torch.configs.methods import config_classes
    classes = config_classes()

    def rebuild(node):
        if isinstance(node, dict) and "__dataclass__" in node:
            name = node["__dataclass__"]
            fields = _drop_foreign(name, {k: v for k, v in node.items()
                                          if k != "__dataclass__"})
            return classes[name](**{k: rebuild(v)
                                    for k, v in fields.items()})
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        return node

    with open(path) as f:
        return rebuild(yaml.safe_load(f))
