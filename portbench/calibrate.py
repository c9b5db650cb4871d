"""The readings a cell's limits are set from (portbench/README.md, "Limits"),
on the card at the cell's own size, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For every seed the program's three first steps go through its Trainer as in a
run (set-up only, no window) and are held against the reference: one JSON
line of the numbers. --control-seeds adds the control, the reference itself
in bfloat16 put in the program's place; --fault-seeds the program with half
of its image left out of the loss ("half_batch"). A step that returns its
state unchanged reads 1 on change_gap by construction and needs no run.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def program_steps(cell, seed, device, tmp, fault=None):
    scene_dir = os.path.join(tmp, "scene")
    scene = harness.Scene(scene_dir, harness.write_scene(
        scene_dir, seed, cell.points, cell.cameras, cell.width, cell.height,
        device))
    trainer = harness.build_trainer(harness.program_argv(
        cell, scene_dir, os.path.join(tmp, "out"), seed, device), seed)
    cams = harness.CameraLog(trainer.scene.dataloader)
    harness.plant_fault(trainer, fault)
    steps = harness.first_steps(trainer, cell, harness.reference(
        cell.config), cams)
    del trainer, cams
    gc.collect()
    return scene, steps


def main(argv=None):
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    a = p.parse_args(argv)
    harness.pin_caches()
    cell = harness.Cell.named(a.workload)
    ref = harness.reference(cell.config)
    ref.configure()

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    jobs = ([(s, "program") for s in ints(a.seeds)]
            + [(s, "control") for s in ints(a.control_seeds)]
            + [(s, "half_batch") for s in ints(a.fault_seeds)])
    out = open(a.out, "a") if a.out else None
    for seed, kind in jobs:
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="portbench-cal-")
        try:
            scene, steps = program_steps(
                cell, seed, a.device, tmp,
                "half_batch" if kind == "half_batch" else None)
            if a.device == "cuda":
                torch.cuda.empty_cache()
            if kind == "control":
                nums = ref.control_readings(cell, scene, steps, a.device,
                                            seed)
            else:
                leaves = {}
                nums = ref.readings(cell, scene, steps, a.device, seed,
                                    leaves)
                nums["leaves"] = leaves
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        line = json.dumps({"cell": cell.name, "seed": seed, "kind": kind,
                           **nums, "losses": steps.losses,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()


if __name__ == "__main__":
    main()
