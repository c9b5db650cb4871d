"""Training loop (port of gssr_tpu/engine/trainer.py).

Same schedule surface as the reference: test/save/checkpoint iterations,
gaussian + checkpoint persistence, resume. Metrics reach the host every
`log_interval` steps, so the device queue stays full in between; each log
point is also kept in `history` with its host time.

Checkpoints are .npz files with the state leaves in gssr_tpu's order
(`leaf_i`, see models/convert.py; the scene converts its own state) plus
the scene's aux arrays (`aux_i`), so a gssr_tpu checkpoint loads into the
port.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from gssr_tpu_torch.configs.base import Config
from gssr_tpu_torch.engine.callbacks import TrainingCallbackLocation


class Trainer:
    def __init__(self, config: Config, scene=None):
        self.config = config
        self.device = config.machine.torch_device()
        config.get_base_dir().mkdir(parents=True, exist_ok=True)
        self.gaussian_dir = config.get_gaussian_dir()
        self.ckpt_dir = config.get_checkpoint_dir()
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

    # ------------------------------------------------------------------
    def train(self):
        scene = self.scene
        tcfg = self.config.trainer
        state = scene.state
        log_interval = max(1, tcfg.log_interval)
        t0 = time.perf_counter()
        ema_loss = None
        mpix_acc = 0.0

        for step in range(self.start_step + 1, tcfg.iterations + 1):
            for cb in self.callbacks:
                cb.run_callback_at_location(
                    step, TrainingCallbackLocation.BEFORE_TRAIN_ITERATION)
            camera = scene.dataloader.next_train()
            mpix_acc += camera.width * camera.height / 1e6
            state, metrics = scene.train_step(state, camera, step)

            if step % log_interval == 0:
                loss = float(metrics["loss"])
                terms = {k: float(v) for k, v in metrics.items()
                         if k.endswith("_loss") or k.startswith("n_")}
                self.history.append((step, loss, int(metrics["num_rendered"]),
                                     time.perf_counter(), terms))
                ema_loss = loss if ema_loss is None else \
                    0.6 * ema_loss + 0.4 * loss
            if step % (log_interval * 50) == 0:
                dt = max(time.perf_counter() - t0, 1e-9)
                print(f"step {step:6d}  loss "
                      f"{-1.0 if ema_loss is None else ema_loss:.4f}  "
                      f"n_active {int(state.n_active)}  "
                      f"{(step - self.start_step) / dt:.1f} it/s  "
                      f"{mpix_acc / dt:.2f} Mpix/s")

            if step in tcfg.test_iterations:
                ev = self.evals[step] = scene.evaluate(state, step)
                print(f"[eval {step}] " + "  ".join(
                    f"{k}={v:.4f}" for k, v in ev.items()))
            if step in tcfg.save_iterations:
                self.save_gaussians(state, step)

            state = scene.densify(state, step)

            if step in tcfg.checkpoint_iterations:
                self.save_checkpoint(state, step)
            for cb in self.callbacks:
                cb.run_callback_at_location(
                    step, TrainingCallbackLocation.AFTER_TRAIN_ITERATION)

        scene.state = state
        return state

    # ------------------------------------------------------------------
    def save_gaussians(self, state, step: int):
        d = self.gaussian_dir / f"iteration_{step}"
        d.mkdir(parents=True, exist_ok=True)
        self.scene.save_gaussians(state, str(d / "point_cloud.ply"))
        print(f"saved gaussians to {d}")

    def save_checkpoint(self, state, step: int):
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
        print(f"resumed from {path} at step {self.start_step}")

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
        print(f"loaded gaussians from {path}")
