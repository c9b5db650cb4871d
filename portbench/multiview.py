"""Readings of the spans the PGSR two-camera step opens
(gssr_tpu_torch/scene/pgsr.py): `pgsr.near_render`, the neighbour camera's
render (its forward; its backward runs later, in autograd's pass), and
`pgsr.multiview`, the forward of the normal, geo and NCC terms. Neither
names a stage (portbench/spans.py): their kernels stay in the render.*
stages and in loss. Each reading is per traced step and returns None
where the trace holds no such span (a program without them).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from portbench import spans

NEAR = "pgsr.near_render"
TERMS = "pgsr.multiview"


def intervals(ctx, names: Sequence[str]) -> Optional[List[tuple]]:
    """The (start, end, name) of every span called one of `names`, or None
    without a trace or without such a span."""
    if ctx.trace is None or not ctx.traced_steps:
        return None
    out = [(h[0], h[0] + h[1], h[2]) for h in ctx.trace.host
           if h[3] == spans.SPAN_CAT and h[2] in names]
    return out or None


def covered(iv: List[tuple], times: List[float]) -> List[bool]:
    """Whether each time lies inside one of the intervals."""
    return [s is not None for s in spans.innermost(iv, times)]


def device_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Device ms of the kernels, copies and sets launched inside the
    spans (by their launch's correlation id)."""
    iv = intervals(ctx, names)
    if iv is None:
        return None
    launch = {h[4]: h[0] for h in ctx.trace.host
              if h[3] in spans.LAUNCH_CATS and h[4] != -1}
    dev = [d for d in ctx.trace.device if d[4] in launch]
    inside = covered(iv, [launch[d[4]] for d in dev])
    return 1e-3 * sum(d[1] for d, c in zip(dev, inside) if c) \
        / ctx.traced_steps


def idle_ms(ctx, names: Sequence[str]) -> Optional[float]:
    """Idle device ms whose gap's midpoint lies inside the spans."""
    iv = intervals(ctx, names)
    if iv is None:
        return None
    gaps = spans.Stages.gaps(ctx.trace, ctx.traced_s)
    inside = covered(iv, [0.5 * (a + b) for a, b in gaps])
    return 1e-3 * sum(b - a for (a, b), c in zip(gaps, inside) if c) \
        / ctx.traced_steps


def waits(ctx, names: Sequence[str]) -> Optional[float]:
    """CUDA runtime calls that wait for the device (spans.is_wait) inside
    the spans, marked by a sync.* span or not."""
    iv = intervals(ctx, names)
    if iv is None:
        return None
    times = [h[0] for h in ctx.trace.host
             if h[3] in spans.LAUNCH_CATS and spans.is_wait(h[2])]
    return sum(covered(iv, times)) / ctx.traced_steps
