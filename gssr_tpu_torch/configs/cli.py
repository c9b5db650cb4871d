"""Minimal dotted-path CLI for the typed config tree (port of
gssr_tpu/configs/cli.py):

  python -m gssr_tpu_torch.train 3dgs --source-path S \
      --scene.gaussians.densify-grad-threshold 2e-4 --machine.device cpu

Dashes and underscores are interchangeable, nested fields are addressed
with dots, values are coerced from the dataclass annotations.
"""
from __future__ import annotations

import dataclasses
import sys
import typing
from typing import List, Optional, get_args, get_origin

from gssr_tpu_torch.configs.base import Config
from gssr_tpu_torch.configs.methods import DESCRIPTIONS, get_method_config


def _coerce(value: str, typ):
    origin = get_origin(typ)
    if origin is not None:
        args = get_args(typ)
        if origin is list or origin is List:
            inner = args[0] if args else str
            if value.strip() == "":
                return []
            return [_coerce(v, inner) for v in value.split(",")]
        if type(None) in args:               # Optional[T]
            if value.lower() in ("none", "null"):
                return None
            inner = [a for a in args if a is not type(None)][0]
            return _coerce(value, inner)
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


def _set_path(obj, path: str, value: str):
    parts = path.split(".")
    chain = [obj]
    for p in parts[:-1]:
        chain.append(getattr(chain[-1], p))
    target = chain[-1]
    leaf = parts[-1]
    if not hasattr(target, leaf):
        raise AttributeError(
            f"config has no field {path!r} (failed at {leaf!r} "
            f"on {type(target).__name__})")
    hints = typing.get_type_hints(type(target))
    typ = hints.get(leaf, type(getattr(target, leaf)))
    new_val = _coerce(value, typ)
    # frozen dataclasses (gaussian configs) rebuild up the chain
    node, attr = target, leaf
    for parent, pname in zip(reversed(chain[:-1]), reversed(parts[:-1])):
        try:
            setattr(node, attr, new_val)
            return
        except dataclasses.FrozenInstanceError:
            new_val = dataclasses.replace(node, **{attr: new_val})
            node, attr = parent, pname
    setattr(node, attr, new_val)


def print_help():
    print("usage: python -m gssr_tpu_torch.train METHOD "
          "[--field.path value ...]\n\nmethods:")
    for k, v in DESCRIPTIONS.items():
        print(f"  {k:16s} {v}")
    print("\ncommon flags: --source-path PATH --output-path PATH "
          "--eval true --trainer.iterations N --machine.device cuda|cpu")


def parse_config(argv: Optional[List[str]] = None) -> Config:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print_help()
        sys.exit(0)
    config = get_method_config(argv.pop(0))
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"expected --flag, got {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
        else:
            i += 1
            if i >= len(argv):
                raise ValueError(f"missing value for {tok}")
            val = argv[i]
        _set_path(config, key.replace("-", "_"), val)
        i += 1
    return config
