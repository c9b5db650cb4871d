#!/usr/bin/env python3
"""List the host syncs of a cell's training step on a CUDA card:

    python3 portbench/syncs.py --workload <cell> [--points N] [--steps S]

builds the cell's trainer as a run does (its scene from --seed, with
--points points if given: a sync site does not depend on the model's
size), trains its first steps, then --steps more under
torch.cuda.set_sync_debug_mode("warn"). Each warning PyTorch gives at a
sync is kept with the program's frames on its stack; the distinct sites
are printed with their count per step, innermost frame first, and, as
the last line, a JSON object of the same. A site the program wraps in a
`sync.*` span (gssr_tpu_torch/utils/tracing.py) is counted by
host_syncs_per_step; one it does not shows in unmarked_syncs_per_step.
PyTorch's debug mode does not see every sync (its own warning says so):
a traced run's unmarked_syncs_per_step is the check that the list is
whole.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback
import warnings
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402
from portbench.scene import write_scene  # noqa: E402

PROGRAM = os.sep + "gssr_tpu_torch" + os.sep


def program_frames(stack) -> tuple:
    """The frames of the program's package, innermost first, as
    "module/path.py:line function"; without one, the three innermost
    frames of any file."""
    out = [f"{f.filename.split(PROGRAM, 1)[1]}:{f.lineno} {f.name}"
           for f in reversed(stack) if PROGRAM in f.filename]
    return tuple(out or [f"{os.path.basename(f.filename)}:{f.lineno} "
                         f"{f.name}" for f in reversed(stack[-3:])])


def scan(cell: harness.Cell, seed: int, steps: int, workdir: str) -> dict:
    import torch
    scene_dir = os.path.join(workdir, "scene")
    write_scene(scene_dir, seed, cell.points, cell.cameras, cell.width,
                cell.height, "cuda")
    trainer = harness.build_trainer(harness.program_argv(
        cell, scene_dir, os.path.join(workdir, "out"), seed, "cuda"), seed)
    trainer.start_step = cell.start_step
    harness.train_to(trainer, trainer.start_step + 3)
    torch.cuda.synchronize()
    sites: Counter = Counter()

    def keep(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            sites[program_frames(traceback.extract_stack()[:-1])] += 1

    show = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = keep
        try:
            harness.train_to(trainer, trainer.start_step + steps)
        finally:
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("default")
    return {"steps": steps,
            "sites": [{"per_step": n / steps, "frames": list(f)}
                      for f, n in sites.most_common()]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2 ** 31 + 11)
    p.add_argument("--points", type=int, default=None)
    p.add_argument("--steps", type=int, default=20)
    a = p.parse_args()
    harness.pin_caches()
    sizes = {} if a.points is None else {"points": a.points}
    cell = harness.Cell.named(a.workload, **sizes)
    with tempfile.TemporaryDirectory(prefix="portbench-syncs-") as tmp:
        out = scan(cell, a.seed, a.steps, tmp)
    for s in out["sites"]:
        print(f"{s['per_step']:8.2f} a step  " + "  <  ".join(s["frames"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
