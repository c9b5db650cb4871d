"""The traced window by stage of the training step, from the program's stage
spans (gssr_tpu_torch/utils/tracing.py lists them) in ctx.trace.

A time's stage is that of the innermost program span that names a stage:
the latest-starting one that still covers it, whatever its thread (so a
span of autograd's thread inside `*.backward` wins). A `sync.*` span names
no stage and so counts as its parent's. A kernel, copy or set belongs to
the stage of its launch (the runtime call with its correlation id); an
idle gap of the device, between the window's start, its busy intervals
and its end, to the stage at its midpoint. A time in no stage span is
`loop`, so the idle of every stage sums to the window's idle:
device_idle_pct times the traced step.

Every reader returns None where the trace holds no stage span (a program
without them).
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Optional

STAGES = ("loop", "dataio", "preprocess", "binning", "blend", "gather_bwd",
          "loss", "backward", "update", "prefilter", "decode")
NAMED = {"trainer.next_train": "dataio", "trainer.log": "loop",
         "trainer.densify": "loop", "render.preprocess": "preprocess",
         "render.color": "preprocess", "render.binning": "binning",
         "render.blend": "blend", "render.blend_backward": "blend",
         "render.gather_backward": "gather_bwd"}
# a scene's spans (vanilla.*, pgsr.*, scaffold.*) by their suffix;
# `*.render_and_loss` names none: its renders and losses have their own
SUFFIX = {"loss": "loss", "backward": "backward", "adam": "update",
          "stats": "update", "prefilter": "prefilter", "decode": "decode"}
SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNC = "sync."
# host calls that wait for the device; the harness's own
# torch.cuda.synchronize (cudaDeviceSynchronize) is not one of them
WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cuStreamSynchronize", "cuEventSynchronize")
WINDOW_START = "cudaDeviceSynchronize"


def stage_of(name: str) -> Optional[str]:
    """The stage a span called `name` names, or None."""
    if name in NAMED:
        return NAMED[name]
    head, _, tail = name.partition(".")
    if head in ("render", "trainer", "sync"):
        return None
    return SUFFIX.get(tail)


def is_wait(name: str) -> bool:
    """A CUDA API call that waits for the device: a stream or
    event synchronize, or a memcpy without Async."""
    if name in WAITS:
        return True
    return name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name


def innermost(spans: List[tuple], times: List[float],
              default: Optional[str] = None) -> List[Optional[str]]:
    """For each time, the label of the latest-starting span (start, end,
    label) that covers it, `default` where none does: one sweep over the
    times in order, the started spans on a heap by start, the ended ones
    dropped from its top."""
    spans = sorted(spans)
    out: List[Optional[str]] = [default] * len(times)
    heap: List[tuple] = []
    i = 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            start, end, label = spans[i]
            heapq.heappush(heap, (-start, end, label))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        if heap:
            out[q] = heap[0][2]
    return out


class Stages:
    """Per-stage sums over one trace (microseconds and counts)."""

    def __init__(self, trace, traced_s: float):
        spans, syncs = [], []
        self.host_us: Dict[str, float] = defaultdict(float)
        for start, dur, name, cat, _ in trace.host:
            if cat != SPAN_CAT:
                continue
            self.host_us[name] += dur
            stage = stage_of(name)
            if name.startswith(SYNC):
                syncs.append((start, start + dur, name))
            elif stage is not None:
                spans.append((start, start + dur, stage))
        self.marked = bool(spans)
        self.syncs = len(syncs)
        self.sync_us = sum(b - a for a, b, _ in syncs)

        launch = {h[4]: h[0] for h in trace.host
                  if h[3] in LAUNCH_CATS and h[4] != -1}
        dev = [d for d in trace.device if d[4] in launch]
        self.device_us: Dict[str, float] = defaultdict(float)
        for d, stage in zip(dev, innermost(spans, [launch[d[4]] for d in dev],
                                           "loop")):
            self.device_us[stage] += d[1]
        for d in trace.device:
            if d[4] not in launch:
                self.device_us["loop"] += d[1]

        gaps = self.gaps(trace, traced_s)
        self.idle_us: Dict[str, float] = defaultdict(float)
        for (a, b), stage in zip(gaps, innermost(
                spans, [0.5 * (a + b) for a, b in gaps], "loop")):
            self.idle_us[stage] += b - a

        waits = [h[0] for h in trace.host
                 if h[3] in LAUNCH_CATS and is_wait(h[2])]
        self.unmarked = sum(s is None for s in innermost(syncs, waits))

    @staticmethod
    def gaps(trace, traced_s: float) -> List[tuple]:
        """The idle intervals of the window: it starts where the harness's
        synchronize before its first step returns and lasts traced_s (the
        first device operation's start without that call)."""
        busy = trace.busy_intervals()
        starts = [h[0] + h[1] for h in trace.host
                  if h[2] == WINDOW_START and h[3] in LAUNCH_CATS]
        if starts:
            w0 = min(starts)
        elif busy:
            w0 = busy[0][0]
        else:
            return []
        w1 = w0 + 1e6 * traced_s
        out, t = [], w0
        for a, b in busy:
            a, b = max(a, w0), min(b, w1)
            if a >= b:
                continue
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if w1 > t:
            out.append((t, w1))
        return out


def stages(ctx) -> Optional[Stages]:
    """The trace's Stages, computed once a run and kept on ctx; None
    without a trace or without stage spans in it."""
    if ctx.trace is None or not ctx.traced_steps:
        return None
    kept = getattr(ctx, "stages", None)
    if kept is None or kept[0] is not ctx.trace:
        kept = ctx.stages = (ctx.trace, Stages(ctx.trace, ctx.traced_s))
    return kept[1] if kept[1].marked else None


def idle_ms(ctx, stage: str) -> Optional[float]:
    """Idle device ms per traced step put down to `stage`."""
    st = stages(ctx)
    return None if st is None else \
        1e-3 * st.idle_us.get(stage, 0.0) / ctx.traced_steps


def device_ms(ctx, stage: str) -> Optional[float]:
    """Device ms per traced step of the operations `stage` launched."""
    st = stages(ctx)
    return None if st is None else \
        1e-3 * st.device_us.get(stage, 0.0) / ctx.traced_steps


def host_ms(ctx, name: str) -> Optional[float]:
    """Host ms per traced step inside the spans called `name`."""
    st = stages(ctx)
    return None if st is None else \
        1e-3 * st.host_us.get(name, 0.0) / ctx.traced_steps


def syncs_per_step(ctx) -> Optional[float]:
    st = stages(ctx)
    return None if st is None else st.syncs / ctx.traced_steps


def sync_wait_ms(ctx) -> Optional[float]:
    st = stages(ctx)
    return None if st is None else 1e-3 * st.sync_us / ctx.traced_steps


def unmarked_per_step(ctx) -> Optional[float]:
    st = stages(ctx)
    return None if st is None else st.unmarked / ctx.traced_steps
