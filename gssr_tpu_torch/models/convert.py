"""Carry a gaussian state across between gssr_tpu and this port.

gssr_tpu's GaussianState is a pytree whose flattened leaves (the order of
`jax.tree.flatten`, also the `leaf_i` order of its .npz checkpoints) are:

  params  xyz, f_dc, f_rest, scaling, rotation, opacity      (0-5)
  adam.m  the same six                                        (6-11)
  adam.v  the same six                                        (12-17)
  adam.count                                                  (18)
  stats   max_radii2d, grad_accum, denom                      (19-21)
  active, n_active                                            (22-23)
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from gssr_tpu_torch.models.vanilla import (
    PARAM_NAMES,
    STAT_NAMES,
    GaussianState,
)

N_LEAVES = 3 * len(PARAM_NAMES) + 1 + len(STAT_NAMES) + 2


def state_from_numpy(leaves: Sequence[np.ndarray], device) -> GaussianState:
    """The port's state on `device` from the reference's leaves."""
    if len(leaves) != N_LEAVES:
        raise ValueError(f"expected {N_LEAVES} state leaves, got "
                         f"{len(leaves)}")
    t = [torch.as_tensor(np.array(x), device=device) for x in leaves]
    k = len(PARAM_NAMES)
    return GaussianState(
        params=dict(zip(PARAM_NAMES, t[0:k])),
        adam_m=dict(zip(PARAM_NAMES, t[k:2 * k])),
        adam_v=dict(zip(PARAM_NAMES, t[2 * k:3 * k])),
        adam_count=t[3 * k].to(torch.int32),
        stats=dict(zip(STAT_NAMES, t[3 * k + 1:3 * k + 4])),
        active=t[3 * k + 4].to(torch.bool),
        n_active=t[3 * k + 5].to(torch.int32))


def state_to_numpy(state: GaussianState) -> List[np.ndarray]:
    """The reference's leaf list from the port's state."""
    tensors = ([state.params[k] for k in PARAM_NAMES]
               + [state.adam_m[k] for k in PARAM_NAMES]
               + [state.adam_v[k] for k in PARAM_NAMES]
               + [state.adam_count]
               + [state.stats[k] for k in STAT_NAMES]
               + [state.active, state.n_active])
    return [x.detach().cpu().numpy() for x in tensors]
