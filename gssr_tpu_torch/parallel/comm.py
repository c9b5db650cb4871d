"""Cross-rank traffic of the multi-device modes (the counterpart of the
`jax.lax` collectives in gssr_tpu's shard_map step code).

Every collective of the port goes through this module, on the default
`torch.distributed` group: one process per device, NCCL on `cuda`, gloo on
`cpu` (parallel/launch.py). Without a group the world is one rank and
every collective is the identity.

Transport. `all_gather` is `all_gather_into_tensor` on every backend, a
copy, exact bit for bit. The gloo of torch 2.11 (the card's) runs it on
CUDA tensors, as it runs all_reduce, all_gather, reduce_scatter_tensor,
all_to_all_single and broadcast there, though PyTorch's backend table
lists only all_reduce and broadcast for gloo on CUDA; gloo stages CUDA
tensors through the host. The two-rank check that shares one card runs
on it (NCCL refuses two ranks on one card), and NCCL runs the same calls.

The two autograd Functions carry the exact-gradient contracts of
gssr_tpu/ops/rasterize.py (`gather_shards`) and ops/band.py:

* `gather_shards`: all-gather forward; backward slices this rank's own
  rows out of the cotangent. Every consumer computes its loss replicated
  on every rank (a full-frame loss), so the cotangent is the same on every
  rank and a summing backward would count it D times.
* `gather_bands`: all-gather of band maps along their rows; backward
  slices this rank's band and scales it by D, as the reference's
  all_gather VJP (a psum_scatter of the D equal cotangents) does. The
  per-gaussian gradients are then averaged over the ranks (pmean in the
  reference): a term that reaches the parameters through the bands sums
  over the bands, and a replicated term that reaches them outside the
  bands (the scaffold scaling loss) counts once, with no rule per term.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.distributed as dist


class Parallel(NamedTuple):
    """A scene's multi-device mode: "none", "dp", "band" or "gshard",
    this process's rank and the number of ranks."""
    mode: str = "none"
    rank: int = 0
    world: int = 1


def group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if group_up() else 0


def world() -> int:
    return dist.get_world_size() if group_up() else 1


def writes(mode: str) -> bool:
    """Whether this process writes its run: rank 0 of a multi-device run
    (`mode` its machine.parallel), every process of a single-device one
    (train_split's tiles, one run each)."""
    return mode == "none" or rank() == 0


def backend() -> str:
    """The group's backend ("nccl", "gloo"), or "none" without a group."""
    return dist.get_backend() if group_up() else "none"


def barrier():
    if group_up():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's `obj` (any picklable value) on every rank."""
    if not group_up():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _reduce_(t: torch.Tensor, op: str) -> torch.Tensor:
    if group_up():
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op])
    return t


def all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """A new tensor, the sum ("sum") or maximum ("max") of x over ranks."""
    return _reduce_(x.detach().clone(), op)


def all_reduce_many(xs: Sequence[torch.Tensor], op: str = "sum"
                    ) -> List[torch.Tensor]:
    """all_reduce of several float tensors in one collective (flattened,
    concatenated and split again; each element's sum is the same)."""
    if not xs:
        return []
    flat = _reduce_(torch.cat([x.detach().reshape(-1).float() for x in xs]),
                    op)
    out, i = [], 0
    for x in xs:
        out.append(flat[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    return out


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """[n, ...] from each rank -> [D * n, ...] in rank order, bit for bit.
    Every rank passes the same n."""
    if not group_up():
        return x.detach().clone()
    x = x.detach().contiguous()
    src = x.view(torch.uint8) if x.dtype == torch.bool else x
    out = src.new_empty((world() * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, src)
    return out.view(x.dtype)


def all_gather_cols(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Several [n, ...] tensors of 4-byte types gathered in one collective
    (their bits side by side as int32 columns), each [D * n, ...]."""
    n = xs[0].shape[0]
    cols = [x.detach().reshape(n, -1).contiguous().view(torch.int32)
            for x in xs]
    g = all_gather(torch.cat(cols, dim=1))
    out, i = [], 0
    for x, c in zip(xs, cols):
        out.append(g[:, i:i + c.shape[1]].contiguous().view(x.dtype)
                   .reshape((-1,) + tuple(x.shape[1:])))
        i += c.shape[1]
    return out


def gather_shard_cols(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """gather_shards of several float [n, ...] tensors in one collective,
    differentiable as each alone."""
    n = xs[0].shape[0]
    flat = [x.reshape(n, -1) for x in xs]
    g = gather_shards(torch.cat(flat, dim=1))
    parts = torch.split(g, [f.shape[1] for f in flat], dim=1)
    return [p.reshape((-1,) + tuple(x.shape[1:])) for p, x in zip(parts, xs)]


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows [r * C/D, (r + 1) * C/D) of a [C, ...] tensor."""
    n = x.shape[0] // world()
    return x[rank() * n:(rank() + 1) * n].clone()


class _GatherRows(torch.autograd.Function):
    """all_gather along axis 0; backward: this rank's rows of the
    cotangent times `scale`."""
    @staticmethod
    def forward(ctx, x, scale):
        ctx.n, ctx.scale = x.shape[0], scale
        return all_gather(x)

    @staticmethod
    def backward(ctx, cot):
        r = rank()
        own = cot[r * ctx.n:(r + 1) * ctx.n]
        return (own if ctx.scale == 1 else own * ctx.scale), None


def gather_shards(x: torch.Tensor) -> torch.Tensor:
    """all_gather along axis 0 whose backward is this rank's slice of the
    replicated cotangent (the module docstring)."""
    return _GatherRows.apply(x, 1)


def gather_bands(x: torch.Tensor) -> torch.Tensor:
    """Band maps [band_h, W, ...] -> the full [H, W, ...]; the backward
    is this rank's band of the cotangent times the number of ranks (the
    module docstring)."""
    return _GatherRows.apply(x, world())
