"""The benchmark of gssr_tpu_torch's training step, driven by data.

A run of one cell (`run`):

1. set-up: write the cell's scene from the seed under $TMPDIR, build the
   program's Trainer from the configuration's method and flags as train.py
   does, train its first three steps through Trainer.train (the reference
   follows them), then `warmup_steps` more;
2. the window: Trainer.train continues the same trainer; a TrainingCallback
   of the harness's own marks every step with a CUDA event and ends the loop
   once `seconds` have passed and a torch.cuda.synchronize() has returned.
   With trace, torch.profiler records the window's first `trace_steps`
   steps (or its first half, whichever ends first);
3. after the window: peak memory is read, the program's state freed, and the
   configuration's reference (portbench/reference/<name>.py) judges the three
   first steps; with trace it also counts the work of the traced steps for
   the per-layer readers (portbench/metrics/<metric>.py).

Everything a cell needs is found by name: portbench/workloads/<cell>.json
names its configuration, portbench/configs/<config>.json its method, flags and
reference, and BENCHMARK.json the metrics the cell reports.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from portbench.scene import Scene, write_scene

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = CHECKOUT / "build" / "portbench"
BANNED = ("jax", "jaxlib", "flax", "gssr_tpu")


def pin_caches():
    """Every build and kernel cache the run may fill, at fixed paths inside
    the checkout (the program builds its own kernels under build/
    gssr_tpu_torch/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or gssr_tpu
    (the whole name: gssr_tpu_torch is not gssr_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config: dict):
    return load_module(HERE / "reference" / f"{config['reference']}.py")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py")


def benchmark(root: Path = CHECKOUT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones without
    trace, its per-layer ones with."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict

    @classmethod
    def named(cls, name: str, **sizes) -> "Cell":
        wl = dict(load("workloads", name))
        wl.update(sizes)
        return cls(name, wl, load("configs", wl["config"]))

    def __getattr__(self, key):
        try:
            return self.workload[key]
        except KeyError:
            raise AttributeError(key) from None

    @property
    def settings(self) -> dict:
        """The method's settings (config fields under `scene.`): the
        configuration's, then the cell's."""
        return {**self.config["settings"], **self.workload["settings"]}

    @property
    def capacity(self) -> int:
        return self.settings["gaussians.capacity"]


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def program_argv(cell: Cell, scene_dir: str, out_dir: str, seed: int,
                 device: str) -> List[str]:
    """train.py's command line for the cell: the configuration's method, the
    cell's settings and the run's seed; no evaluation, saving or event
    files."""
    argv = [cell.config["method"], "--source-path", scene_dir,
            "--output-path", out_dir, "--writer", "none",
            "--trainer.test-iterations", "", "--trainer.save-iterations", "",
            "--machine.device", device,
            "--machine.seed", str(seed % (1 << 31))]
    for key, value in cell.settings.items():
        argv += [f"--scene.{key}",
                 str(value).lower() if isinstance(value, bool) else
                 str(value)]
    return argv


def build_trainer(argv: List[str], seed: int):
    """The Trainer train.py would build for argv, set up (train.py::_train
    without its run directory files)."""
    import random

    import numpy as np
    import torch

    from gssr_tpu_torch.configs.cli import parse_config
    from gssr_tpu_torch.engine.trainer import Trainer
    config = parse_config(list(argv))
    random.seed(config.machine.seed)
    np.random.seed(config.machine.seed)
    torch.manual_seed(config.machine.seed)
    trainer = Trainer(config)
    trainer.setup()
    return trainer


class CameraLog:
    """Wraps the dataloader's next_train: the name of every camera drawn and
    the host seconds of each call (the dataio.wait span)."""

    def __init__(self, dataloader):
        self.names: List[str] = []
        self.seconds: List[float] = []
        self._next = dataloader.next_train
        dataloader.next_train = self

    def __call__(self):
        t = time.perf_counter()
        cam = self._next()
        self.seconds.append(time.perf_counter() - t)
        self.names.append(cam.image_name)
        return cam


def plant_fault(trainer, fault: Optional[str]):
    """Break the timed path underneath the harness (the faults the check
    must catch): "frozen", a step that returns its state unchanged;
    "half_batch", a loss over the top half of the image rows only."""
    scene = trainer.scene
    if fault is None:
        return
    if fault == "frozen":
        step = scene.train_step

        def frozen(state, camera, it):
            return state, step(state, camera, it)[1]
        scene.train_step = frozen
    elif fault == "half_batch":
        terms = scene.loss_terms

        def half(out, gt, it, camera):
            rows = gt.shape[0] // 2
            return terms(out._replace(image=out.image[:rows]), gt[:rows], it,
                         camera)
        scene.loss_terms = half
    else:
        raise ValueError(f"unknown fault {fault!r}")


def train_to(trainer, step: int, log_interval: Optional[int] = None):
    """Trainer.train from trainer.start_step to `step`."""
    tcfg = trainer.config.trainer
    keep = tcfg.log_interval
    if log_interval is not None:
        tcfg.log_interval = log_interval
    tcfg.iterations = step
    try:
        trainer.train()
    finally:
        tcfg.log_interval = keep
    trainer.start_step = step


@dataclass
class ProgramSteps:
    """What the reference judges: the program's model before step 1 and its
    state after steps 1 and 3 (on the host), the losses of steps 1-3 and
    their cameras."""
    before: Dict[str, object]
    after1: object
    after3: Dict[str, object]
    losses: List[float]
    cameras: List[str]


def first_steps(trainer, cell: Cell, ref, cameras: CameraLog
                ) -> ProgramSteps:
    """Train steps 1-3 of the cell through Trainer.train, logging every
    step, and keep what the reference needs."""
    s0 = cell.start_step
    trainer.start_step = s0
    before = ref.program_params(trainer.scene.state)
    train_to(trainer, s0 + 1, log_interval=1)
    after1 = ref.program_step_state(trainer.scene.state)
    train_to(trainer, s0 + 3, log_interval=1)
    after3 = ref.program_params(trainer.scene.state)
    losses = [h[1] for h in trainer.history[-3:]]
    return ProgramSteps(before, after1, after3, losses, cameras.names[-3:])


class WindowEnd(Exception):
    """Raised by the window's callback to end Trainer.train."""


class Window:
    """The measured window: marks each step with a CUDA event after it, ends
    the loop after `seconds` and a synchronize, and stops the profiler after
    the traced steps."""

    def __init__(self, seconds: float, profiler=None, trace_steps: int = 0,
                 trace_path: Optional[str] = None):
        import torch
        self.torch = torch
        self.seconds = seconds
        self.profiler = profiler
        self.trace_steps = trace_steps
        self.trace_path = trace_path
        self.events = []
        self.steps = 0
        self.traced_steps = 0
        self.traced_s = 0.0

    def start(self):
        torch = self.torch
        if self.profiler is not None:
            self.profiler.start()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.events.append(torch.cuda.Event(enable_timing=True))
        self.events[-1].record()

    def after_step(self, step: int):
        torch = self.torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        self.steps += 1
        now = time.perf_counter() - self.t0
        if self.profiler is not None and (
                self.steps >= self.trace_steps or now >= self.seconds / 2):
            torch.cuda.synchronize()
            self.traced_s = time.perf_counter() - self.t0
            self.traced_steps = self.steps
            self.profiler.stop()
            self.profiler.export_chrome_trace(self.trace_path)
            self.profiler = None
            now = time.perf_counter() - self.t0
        if now >= self.seconds:
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self.t0
            raise WindowEnd

    def step_seconds(self) -> List[float]:
        return [a.elapsed_time(b) / 1e3
                for a, b in zip(self.events, self.events[1:])]


def run_window(trainer, seconds: float, profiler=None, trace_steps: int = 0,
               trace_path: Optional[str] = None) -> Window:
    from gssr_tpu_torch.engine.callbacks import (
        TrainingCallback,
        TrainingCallbackLocation,
    )
    win = Window(seconds, profiler, trace_steps, trace_path)
    cb = TrainingCallback("portbench.window",
                          [TrainingCallbackLocation.AFTER_TRAIN_ITERATION],
                          win.after_step)
    trainer.callbacks.append(cb)
    trainer.config.trainer.iterations = trainer.start_step + 10 ** 9
    win.start()
    try:
        trainer.train()
    except WindowEnd:
        pass
    else:
        raise RuntimeError("the window's loop ended before its time")
    finally:
        trainer.callbacks.remove(cb)
    return win


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

@dataclass
class Context:
    """What the metric readers read (portbench/metrics/*.py)."""
    cell: Cell
    setup_s: float
    steps: int
    window_s: float
    step_s: List[float]
    peak_bytes: int
    trace: Optional[object] = None
    traced_steps: int = 0
    traced_s: float = 0.0
    dataio_s: List[float] = field(default_factory=list)
    work: Optional[dict] = None


def chip_name() -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", fault: Optional[str] = None,
        t_start: Optional[float] = None, bench: Optional[dict] = None,
        workdir: Optional[str] = None) -> dict:
    """One run of the cell; returns the contract's result object."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    ref = reference(cell.config)
    ref.configure()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tmp = workdir or tempfile.mkdtemp(prefix="portbench-")
    try:
        scene_dir = os.path.join(tmp, "scene")
        scene = Scene(scene_dir, write_scene(
            scene_dir, seed, cell.points, cell.cameras, cell.width,
            cell.height, device))
        trainer = build_trainer(program_argv(cell, scene_dir,
                                             os.path.join(tmp, "out"), seed,
                                             device), seed)
        cams = CameraLog(trainer.scene.dataloader)
        plant_fault(trainer, fault)
        steps = first_steps(trainer, cell, ref, cams)
        train_to(trainer, trainer.start_step + cell.warmup_steps)
        sync = torch.cuda.synchronize if on_card else (lambda: None)
        sync()
        pre_window = ref.program_params(trainer.scene.state) if trace \
            else None
        profiler, trace_path = None, None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            profiler = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
            trace_path = os.path.join(tmp, "trace.json")
        setup_s = time.perf_counter() - t_start
        n_cam = len(cams.seconds)
        if on_card:
            win = run_window(trainer, seconds, profiler,
                             cell.workload.get("trace_steps", 16),
                             trace_path)
            step_s, window_s, n_steps = (win.step_seconds(), win.wall_s,
                                         win.steps)
            peak = torch.cuda.max_memory_allocated()
        else:
            # the CPU rehearsal: a fixed number of steps, no clock
            n_steps = cell.workload.get("cpu_window_steps", 2)
            train_to(trainer, trainer.start_step + n_steps)
            step_s, window_s, peak, win = [0.0] * n_steps, 0.0, 0, None
        window_names = cams.names[n_cam:]
        dataio_s = cams.seconds[n_cam:]
        del trainer, cams
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        ctx = Context(cell, setup_s, n_steps, window_s, step_s, peak)
        if trace and win is not None:
            from portbench import tracing
            ctx.trace = tracing.Trace.load(trace_path)
            ctx.traced_steps, ctx.traced_s = win.traced_steps, win.traced_s
            ctx.dataio_s = dataio_s[:win.traced_steps]
            ctx.work = ref.work(cell, scene, pre_window,
                                window_names[:win.traced_steps], device)
        checks = ref.judge(cell, scene, steps, device, seed)
    finally:
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)

    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in cell_metrics(bench, cell.name, trace) if on_card else []:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = chip_name() if on_card else {"platform": "cpu", "kind": "cpu",
                                       "count": 0}
    dev["memory_peak_bytes"] = peak
    out = {"correct": correct, "attempted": n_steps, "failed": 0,
           "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.traced_s
        out["breakdown"] = ctx.trace.breakdown()
    if on_card:
        out["window"] = step_summary(step_s)
    out["checks"] = checks
    return out


def check_lines(checks: dict) -> List[str]:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in checks.items()]


def step_summary(step_s: List[float]) -> dict:
    """The window's steps as chip_smoke.py::step_line gives them: the median
    and the highest percentile with ten samples above it, in ms, and their
    count (the result's "window" key, beside its metrics)."""
    s = sorted(step_s)
    tail_n = len(s) - 10
    out = {"median_ms": 1e3 * statistics.median(s), "n": len(s)}
    if tail_n > len(s) // 2:
        out[f"p{100 * tail_n / len(s):.0f}_ms"] = 1e3 * s[tail_n - 1]
    return out


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    pin_caches()
    bench = benchmark()
    cell = Cell.named(a.workload)
    import torch
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run(cell, a.seed, a.seconds, bool(a.trace), t_start=t_start,
                 bench=bench)
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
