"""Training loop (port of gssr_tpu/engine/trainer.py).

Same schedule surface as the reference: test/save/checkpoint iterations,
gaussian + checkpoint persistence, TensorBoard scalars, a profiler
window, resume. Metrics reach the host every `log_interval` steps, in one
transfer, so the device queue stays full in between; each log point is
also kept in `history` with its host time. The loop's own stages run in
utils/tracing.py spans (trainer.next_train, trainer.log, trainer.densify;
sync.log and sync.progress around its two reads of the device).

Checkpoints are .npz files with the state leaves in gssr_tpu's order
(`leaf_i`, see models/convert.py; the scene converts its own state) plus
the scene's aux arrays (`aux_i`), so a gssr_tpu checkpoint loads into the
port.

With `machine.parallel` set, every rank of the torch.distributed group
runs this loop (parallel/launch.py): setup calls the scene's
setup_parallel, a dp step draws one camera per rank from the shared
sequence and rank r trains the r-th, and only rank 0 logs and writes
(the others wait at a barrier after each write). Under gshard the loop
holds the scene's sharded layout; evaluation and saving see the whole
state.
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np
import torch

from gssr_tpu_torch.configs.base import Config
from gssr_tpu_torch.engine.callbacks import TrainingCallbackLocation
from gssr_tpu_torch.parallel import comm
from gssr_tpu_torch.utils.tracing import span


def host_metrics(metrics: dict) -> dict:
    """A step's metrics as Python floats, in their order. The 0-d tensors
    on the device come to the host in one transfer."""
    on_dev = [k for k, v in metrics.items()
              if torch.is_tensor(v) and v.device.type != "cpu"]
    out = {k: float(v) for k, v in metrics.items() if k not in on_dev}
    if on_dev:
        stacked = torch.stack([metrics[k].to(torch.float64)
                               for k in on_dev])
        with span("sync.log"):
            vals = stacked.tolist()
        out.update(zip(on_dev, vals))
    return {k: out[k] for k in metrics}


class Trainer:
    def __init__(self, config: Config, scene=None):
        self.config = config
        self.device = config.machine.torch_device()
        # rank 0 of a multi-device run logs and writes; the others wait
        self.multi = config.machine.parallel != "none"
        self.main = comm.writes(config.machine.parallel)
        base_dir = config.get_base_dir()
        if self.main:
            base_dir.mkdir(parents=True, exist_ok=True)
        self.gaussian_dir = config.get_gaussian_dir()
        self.ckpt_dir = config.get_checkpoint_dir()
        self.writer = None
        if config.writer == "tensorboard" and self.main:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self.writer = SummaryWriter(
                    str(base_dir / config.relative_log_dir))
        self.scene = scene
        self.start_step = 0
        self.callbacks = []
        # (step, loss, num_rendered, host seconds, {loss term or n_ count:
        # value}) at every log point
        self.history = []
        self.evals = {}               # step -> evaluate() metrics

    def setup(self):
        if self.scene is None:
            from gssr_tpu_torch.configs.methods import build_scene
            self.scene = build_scene(self.config, self.device)
        t = self.config.trainer
        if t.load_gaussian_dir is not None:
            self._load_gaussians()
        if t.load_ckpt_dir is not None:
            self._load_checkpoint()
        # the scene's hooks, run before and after every train iteration
        self.callbacks = list(self.scene.get_training_callbacks(self) or [])
        m = self.config.machine
        if self.multi:
            world = comm.world()
            if m.num_devices and m.num_devices != world:
                raise ValueError(f"machine.num_devices {m.num_devices} but "
                                 f"the group has {world} ranks")
            self.scene.setup_parallel(m.parallel)
            self._print(f"multi-device: mode={m.parallel} over {world} "
                        f"ranks, backend {comm.backend()}")

    def _print(self, *args):
        if self.main:
            print(*args, flush=True)

    def sync(self):
        """The other ranks of a multi-device run wait for rank 0's write."""
        if self.multi:
            comm.barrier()

    # ------------------------------------------------------------------
    def train(self):
        scene = self.scene
        tcfg = self.config.trainer
        par = scene.parallel
        state = scene.step_state(scene.state)
        log_interval = max(1, tcfg.log_interval)
        t0 = time.perf_counter()
        ema_loss = None
        mpix_acc = 0.0

        profiler = None
        profile_steps = tcfg.profile_steps \
            if tcfg.profile_dir and self.main else []

        for step in range(self.start_step + 1, tcfg.iterations + 1):
            if profile_steps and step == profile_steps[0]:
                profiler = self._start_profiler()
            for cb in self.callbacks:
                cb.run_callback_at_location(
                    step, TrainingCallbackLocation.BEFORE_TRAIN_ITERATION)
            # dp: one camera per rank from the shared sequence, the step
            # takes them all and trains its own
            with span("trainer.next_train"):
                cams = [scene.dataloader.next_train()
                        for _ in range(par.world if par.mode == "dp" else 1)]
            mpix_acc += sum(c.width * c.height for c in cams) / 1e6
            state, metrics = scene.train_step(
                state, cams if par.mode == "dp" else cams[0], step)
            if profiler is not None and len(profile_steps) > 1 \
                    and step == profile_steps[1]:
                self._stop_profiler(profiler)
                profiler = None

            if step % log_interval == 0:
                with span("trainer.log"):
                    m = host_metrics(metrics)
                loss = m["loss"]
                terms = {k: v for k, v in m.items()
                         if k.endswith("_loss") or k.startswith("n_")}
                self.history.append((step, loss, int(m["num_rendered"]),
                                     time.perf_counter(), terms))
                ema_loss = loss if ema_loss is None else \
                    0.6 * ema_loss + 0.4 * loss
                self._scalars("train", m, step)
            if step % (log_interval * 50) == 0:
                dt = max(time.perf_counter() - t0, 1e-9)
                with span("trainer.log"), span("sync.progress"):
                    n_active = int(state.n_active)
                self._print(f"step {step:6d}  loss "
                            f"{-1.0 if ema_loss is None else ema_loss:.4f}  "
                            f"n_active {n_active}  "
                            f"{(step - self.start_step) / dt:.1f} it/s  "
                            f"{mpix_acc / dt:.2f} Mpix/s")
                self._scalars("perf", {"mpix_per_s": mpix_acc / dt}, step)

            if step in tcfg.test_iterations:
                ev = self.evals[step] = scene.evaluate(
                    scene.full_state(state), step)
                self._print(f"[eval {step}] " + "  ".join(
                    f"{k}={v:.4f}" for k, v in ev.items()))
                self._scalars("eval", ev, step)
            if step in tcfg.save_iterations:
                self.save_gaussians(scene.full_state(state), step)

            with span("trainer.densify"):
                state = scene.train_densify(state, step)

            if step in tcfg.checkpoint_iterations:
                self.save_checkpoint(scene.full_state(state), step)
            for cb in self.callbacks:
                cb.run_callback_at_location(
                    step, TrainingCallbackLocation.AFTER_TRAIN_ITERATION)

        if profiler is not None:         # the window outlasted the run
            self._stop_profiler(profiler)
        if self.writer is not None:
            # the run's scalars are written: stop the writer's thread, which
            # would otherwise outlive the run (a tile sweep makes one a tile)
            self.writer.close()
            self.writer = None
        scene.state = scene.full_state(state)
        return scene.state

    def _scalars(self, group: str, values: dict, step: int):
        if self.writer is not None:
            for k, v in values.items():
                self.writer.add_scalar(f"{group}/{k}", v, step)

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Stops the window and writes its chrome trace into
        trainer.profile_dir."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        tcfg = self.config.trainer
        os.makedirs(tcfg.profile_dir, exist_ok=True)
        steps = "-".join(map(str, tcfg.profile_steps[:2]))
        profiler.export_chrome_trace(
            os.path.join(tcfg.profile_dir, f"trace_steps_{steps}.json"))
        print(f"profiler trace written to {tcfg.profile_dir}")

    # ------------------------------------------------------------------
    def save_gaussians(self, state, step: int):
        if self.main:
            d = self.gaussian_dir / f"iteration_{step}"
            d.mkdir(parents=True, exist_ok=True)
            self.scene.save_gaussians(state, str(d / "point_cloud.ply"))
            print(f"saved gaussians to {d}")
        self.sync()

    def save_checkpoint(self, state, step: int):
        if self.main:
            self._write_checkpoint(state, step)
        self.sync()

    def _write_checkpoint(self, state, step: int):
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        path = self.ckpt_dir / f"ckpt_{step:07d}.npz"
        leaves = self.scene.state_to_numpy(state)
        np.savez(path, step=step,
                 **{f"leaf_{i}": a for i, a in enumerate(leaves)},
                 **{f"aux_{i}": a
                    for i, a in enumerate(self.scene.aux_arrays())})
        if self.config.trainer.save_only_latest_checkpoint:
            for p in sorted(self.ckpt_dir.glob("ckpt_*.npz"))[:-1]:
                p.unlink()
        print(f"saved checkpoint {path}")

    def _load_checkpoint(self):
        t = self.config.trainer
        d = Path(t.load_ckpt_dir)
        if t.load_ckpt_step is not None:
            path = d / f"ckpt_{t.load_ckpt_step:07d}.npz"
        else:
            cands = sorted(d.glob("ckpt_*.npz"))
            if not cands:
                raise FileNotFoundError(f"no checkpoints in {d}")
            path = cands[-1]
        with np.load(path) as data:
            self.start_step = int(data["step"])
            n = len([k for k in data.files if k.startswith("leaf_")])
            self.scene.state = self.scene.state_from_numpy(
                [data[f"leaf_{i}"] for i in range(n)])
            n_aux = len([k for k in data.files if k.startswith("aux_")])
            if n_aux:
                self.scene.restore_aux([data[f"aux_{i}"]
                                        for i in range(n_aux)])
        self._print(f"resumed from {path} at step {self.start_step}")

    def _load_gaussians(self):
        t = self.config.trainer
        d = Path(t.load_gaussian_dir)
        step = t.load_gaussian_step
        if step is None:
            iters = [int(p.name.split("_")[-1])
                     for p in d.glob("iteration_*")]
            if not iters:
                raise FileNotFoundError(f"no saved gaussians in {d}")
            step = max(iters)
        path = d / f"iteration_{step}" / "point_cloud.ply"
        self.scene.state = self.scene.load_gaussians(str(path))
        self._print(f"loaded gaussians from {path}")
