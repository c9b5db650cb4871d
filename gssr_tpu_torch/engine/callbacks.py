"""Training callbacks.

A copy of gssr_tpu/engine/callbacks.py: user hooks run before or after a
train iteration, every N iterations or at listed iterations. The per-step
schedules (LR, SH degree) live in the scene's train step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Callable, List, Optional


class TrainingCallbackLocation(Enum):
    BEFORE_TRAIN_ITERATION = auto()
    AFTER_TRAIN_ITERATION = auto()


@dataclass
class TrainingCallback:
    label: str
    where_to_run: List[TrainingCallbackLocation]
    func: Callable
    update_every_num_iters: Optional[int] = None
    iters: Optional[tuple] = None
    args: list = field(default_factory=list)
    kwargs: dict = field(default_factory=dict)

    def run_callback_at_location(self, step: int,
                                 location: TrainingCallbackLocation):
        if location not in self.where_to_run:
            return
        if self.update_every_num_iters is not None:
            if step % self.update_every_num_iters == 0:
                self.func(step, *self.args, **self.kwargs)
        elif self.iters is not None:
            if step in self.iters:
                self.func(step, *self.args, **self.kwargs)
        else:
            self.func(step, *self.args, **self.kwargs)
