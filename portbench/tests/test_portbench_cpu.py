"""Each cell at a tiny size on the CPU, through the harness's own run: the
program's plain path agrees with the reference within the cell's limits,
while the control (the reference in bfloat16 in the program's place) and
each fault the cell can have (a step that returns its state unchanged; half
of the image left out of the loss) fail at least one of them. The card's
run of the same (cuda marker) decides inside the test whether a card is
there."""
import json
import os

import pytest
import torch

from portbench import calibrate, harness

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = dict(points=3000, width=64, height=48, cameras=8)
SEED = 2 ** 31 + 977


def tiny(cell: str) -> harness.Cell:
    c = harness.Cell.named(cell, **TINY)
    cap = -(-8 * TINY["points"] // 128) * 128
    c.workload["settings"] = {**c.workload["settings"],
                              "gaussians.capacity": cap}
    return c


def failed(checks) -> list:
    return [k for k, v in checks.items() if not v["value"] <= v["limit"]]


@pytest.fixture(autouse=True)
def small_threads(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path):
    out = harness.run(tiny(cell), SEED, 1.0, False, device="cpu",
                      bench=BENCH, workdir=str(tmp_path))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_fault_is_caught(cell, fault, tmp_path):
    out = harness.run(tiny(cell), SEED, 1.0, False, device="cpu",
                      fault=fault, bench=BENCH, workdir=str(tmp_path))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, tmp_path):
    c = tiny(cell)
    ref = harness.reference(c.config)
    scene, steps = calibrate.program_steps(c, SEED, "cpu", str(tmp_path))
    nums = ref.control_readings(c, scene, steps, "cpu", SEED)
    assert failed({k: {"value": v, "limit": c.limits[k]}
                   for k, v in nums.items()}), nums


@pytest.mark.cuda
def test_card_run_small(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = harness.run(tiny(CELLS[0]), SEED, 2.0, True, bench=BENCH,
                      workdir=str(tmp_path))
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
