"""The traced window, from torch.profiler's chrome trace: device activity
(kernels, copies, sets), host operations, and what the readers and the
result's breakdown take from them."""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def short(name: str, width: int = 96) -> str:
    """A device operation's name cut to `width` characters."""
    return name[:width] if name else "(unnamed)"


def is_kernel(name: str, kernel: str) -> bool:
    """Whether a trace's kernel name is the function `kernel`, whatever its
    namespace, template and argument list ("(anonymous
    namespace)::blend_fwd_kernel(float const*, ...)" is blend_fwd_kernel)."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(")[0].split("<")[0]
    return head.rsplit("::", 1)[-1].rsplit(" ", 1)[-1] == kernel


class Trace:
    def __init__(self, device: List[tuple], host: List[tuple]):
        # (start us, duration us, name, category, correlation id), sorted
        # by start
        self.device = sorted(device)
        self.host = sorted(host)
        self._starts = [h[0] for h in self.host]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            row = (float(e["ts"]), float(e["dur"]), e.get("name", ""),
                   e.get("cat", ""), e.get("args", {}).get("correlation", -1))
            if row[3] in DEVICE_CATS:
                dev.append(row)
            elif row[3] in HOST_CATS:
                host.append(row)
        return cls(dev, host)

    def kernels(self) -> list:
        return [d for d in self.device if d[3] == "kernel"]

    def kernel_seconds(self, name: str) -> float:
        """Device seconds of the kernels called `name`."""
        return sum(d[1] for d in self.kernels()
                   if is_kernel(d[2], name)) / 1e6

    def op_device_seconds(self, op: str) -> float:
        """Device seconds of the kernels that the host operation `op`
        launched: those whose launch (matched by correlation id) lies in one
        of its spans."""
        spans = [(h[0], h[0] + h[1]) for h in self.host if h[2] == op]
        ids = {h[4] for h in self.host if h[3] == "cuda_runtime"
               and any(a <= h[0] <= b for a, b in spans)}
        return sum(d[1] for d in self.device if d[4] in ids) / 1e6

    def host_seconds(self, name: str) -> float:
        """Host seconds inside the ranges called `name`."""
        return sum(h[1] for h in self.host if h[2] == name) / 1e6

    def busy_intervals(self) -> List[tuple]:
        out: List[List[float]] = []
        for start, dur, *_ in self.device:
            end = start + dur
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def host_at(self, t: float) -> str:
        """The innermost host operation running at time t (nested spans:
        the latest-starting one that still covers t)."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - 4000, -1), -1):
            start, dur, name = self.host[j][:3]
            if start + dur >= t:
                return name
        return "(no host operation)"

    def gaps(self) -> Dict[str, float]:
        """Idle device seconds between busy intervals, by the host operation
        running in the middle of each gap."""
        out: Dict[str, float] = defaultdict(float)
        iv = self.busy_intervals()
        for (_, end), (start, _) in zip(iv, iv[1:]):
            out[self.host_at(0.5 * (end + start))] += (start - end) / 1e6
        return out

    def breakdown(self) -> dict:
        ops: Dict[str, float] = defaultdict(float)
        for _, dur, name, *_ in self.device:
            ops[short(name)] += dur / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps().items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}
