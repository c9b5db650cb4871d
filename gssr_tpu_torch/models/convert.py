"""Carry a gaussian or scaffold state across between gssr_tpu and this
port.

gssr_tpu's GaussianState is a pytree whose flattened leaves (the order of
`jax.tree.flatten`, also the `leaf_i` order of its .npz checkpoints) are:

  params  xyz, f_dc, f_rest, scaling, rotation, opacity      (0-5)
  adam.m  the same six                                        (6-11)
  adam.v  the same six                                        (12-17)
  adam.count                                                  (18)
  stats   max_radii2d, grad_accum, denom                      (19-21)
  active, n_active                                            (22-23)

and its ScaffoldState's:

  anchors      anchor, offset, feat, scaling, rotation, opacity   (0-5)
  mlp          the 17 MLP fields (models/scaffold.py MLP_NAMES)   (6-22)
  adam_anchor  m (6), v (6), count                                (23-35)
  adam_mlp     m (17), v (17), count                              (36-70)
  stats        opacity_accum, anchor_denom, offset_grad_accum,
               offset_denom                                       (71-74)
  active, n_active                                                (75-76)
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from gssr_tpu_torch.models.scaffold import (
    ANCHOR_NAMES,
    MLP_NAMES,
    ScaffoldState,
)
from gssr_tpu_torch.models.scaffold import STAT_NAMES as SCAFFOLD_STATS
from gssr_tpu_torch.models.vanilla import (
    PARAM_NAMES,
    STAT_NAMES,
    Adam,
    GaussianState,
)

N_LEAVES = 3 * len(PARAM_NAMES) + 1 + len(STAT_NAMES) + 2
N_SCAFFOLD_LEAVES = (3 * (len(ANCHOR_NAMES) + len(MLP_NAMES)) + 2
                     + len(SCAFFOLD_STATS) + 2)


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


def scaffold_state_from_numpy(leaves: Sequence[np.ndarray],
                              device) -> ScaffoldState:
    """The port's scaffold state on `device` from the reference's leaves."""
    if len(leaves) != N_SCAFFOLD_LEAVES:
        raise ValueError(f"expected {N_SCAFFOLD_LEAVES} scaffold state "
                         f"leaves, got {len(leaves)}")
    it = iter(torch.as_tensor(np.array(x), device=device) for x in leaves)

    def take(names):
        return {k: next(it) for k in names}

    anchors, mlp = take(ANCHOR_NAMES), take(MLP_NAMES)
    adam_anchor = Adam(take(ANCHOR_NAMES), take(ANCHOR_NAMES),
                       next(it).to(torch.int32))
    adam_mlp = Adam(take(MLP_NAMES), take(MLP_NAMES),
                    next(it).to(torch.int32))
    stats = take(SCAFFOLD_STATS)
    return ScaffoldState(anchors=anchors, mlp=mlp, adam_anchor=adam_anchor,
                         adam_mlp=adam_mlp, stats=stats,
                         active=next(it).to(torch.bool),
                         n_active=next(it).to(torch.int32))


def scaffold_state_to_numpy(state: ScaffoldState) -> List[np.ndarray]:
    """The reference's leaf list from the port's scaffold state."""
    a, m = state.adam_anchor, state.adam_mlp
    tensors = ([state.anchors[k] for k in ANCHOR_NAMES]
               + [state.mlp[k] for k in MLP_NAMES]
               + [a.m[k] for k in ANCHOR_NAMES]
               + [a.v[k] for k in ANCHOR_NAMES] + [a.count]
               + [m.m[k] for k in MLP_NAMES]
               + [m.v[k] for k in MLP_NAMES] + [m.count]
               + [state.stats[k] for k in SCAFFOLD_STATS]
               + [state.active, state.n_active])
    return [x.detach().cpu().numpy() for x in tensors]
