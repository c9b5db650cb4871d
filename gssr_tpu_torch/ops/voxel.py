"""Voxel-grid helpers of the anchor models (port of gssr_tpu/ops/voxel.py).

Voxel coordinates hash to int32 keys, and a stable sort deduplicates them
against each other and against the existing anchors' keys. The keys equal
the reference's bit for bit: PyTorch has little uint32 arithmetic, so the
hash works on int64 values masked to 32 bits, multiplying in 16-bit halves
so that no product leaves int64. A key that differed would change which
candidate anchors survive the dedup.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_H1, _H2, _H3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
KEY_MAX = int(np.iinfo(np.int32).max)
_M32 = 0xFFFFFFFF


def _mul32(c, h: int):
    """(c * h) mod 2^32 for int64 c in [0, 2^32)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (lo * h + ((hi * h) & 0xFFFF) * 65536) & _M32


def hash_coords(coords):
    """[N, 3] int32 voxel coordinates -> [N] int32 keys (never KEY_MAX)."""
    c = coords.to(torch.int64) & _M32          # the uint32 view
    h = _mul32(c[..., 0], _H1) ^ _mul32(c[..., 1], _H2) \
        ^ _mul32(c[..., 2], _H3)
    h = h ^ (h >> 15)
    key = (h & 0x7FFFFFFF).to(torch.int32)
    return torch.clamp(key, max=KEY_MAX - 1)


class VoxelDedup(NamedTuple):
    order: torch.Tensor        # [N] int64, stable argsort of the keys
    sorted_keys: torch.Tensor  # [N] int32, invalid keys (KEY_MAX) last
    is_new: torch.Tensor       # [N] bool in sorted order: the first of
                               #     its run, valid, and not existing
    seg_id: torch.Tensor       # [N] int64 run id per sorted element


def dedup_against(cand_keys, cand_valid, existing_sorted_keys) -> VoxelDedup:
    """Deduplicate candidate voxel keys and drop those already existing.
    existing_sorted_keys is sorted ascending, invalid slots KEY_MAX. The
    sort is stable, as jax.lax.sort's is."""
    keys = torch.where(cand_valid, cand_keys,
                       torch.full_like(cand_keys, KEY_MAX))
    sorted_keys, order = torch.sort(keys, stable=True)
    prev = torch.cat([torch.full((1,), -1, dtype=sorted_keys.dtype,
                                 device=keys.device), sorted_keys[:-1]])
    first = sorted_keys != prev
    pos = torch.searchsorted(existing_sorted_keys, sorted_keys)
    pos = torch.clamp(pos, max=existing_sorted_keys.shape[0] - 1)
    exists = existing_sorted_keys[pos] == sorted_keys
    is_new = first & ~exists & (sorted_keys != KEY_MAX)
    seg_id = torch.cumsum(first.to(torch.int64), 0) - 1
    return VoxelDedup(order=order, sorted_keys=sorted_keys, is_new=is_new,
                      seg_id=seg_id)


def segment_max_sorted(values_sorted, seg_id, num_segments: int):
    """Per-run max of values sorted by key, [N, F] -> [num_segments, F];
    a run with no element holds -inf, as jax.ops.segment_max gives. A max
    does not depend on the order of its operands."""
    out = torch.full((num_segments,) + values_sorted.shape[1:],
                     float("-inf"), dtype=values_sorted.dtype,
                     device=values_sorted.device)
    idx = seg_id.reshape((-1,) + (1,) * (values_sorted.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(values_sorted),
                              values_sorted, reduce="amax")


def voxelize_points_host(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Host-side point voxelization for the anchors' init: the centre of
    every voxel that holds a point, in np.unique's (sorted) row order."""
    coords = np.unique(np.round(points / voxel_size), axis=0)
    return coords * voxel_size
