"""Every file the benchmark finds by name is there, and BENCHMARK.json keeps
to the shape its contract asks for."""
import json
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_workload_names_a_configuration_that_exists(cell):
    wl = harness.load("workloads", cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"]
    assert wl["why"] == entry["why"] and len(wl["why"]) <= 200
    cfg = harness.load("configs", wl["config"])
    assert (harness.HERE / "reference" / f"{cfg['reference']}.py").is_file()
    c = harness.Cell.named(cell)
    assert c.capacity >= c.points
    assert set(wl["limits"]) == {"loss_gap", "grad_gap", "change_gap",
                                 "start_gap"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_names_a_reader_that_exists(metric):
    assert callable(harness.metric_reader(metric).read)


def test_configs_entries_name_their_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        data = json.loads((harness.CHECKOUT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        e = harness.cell_metrics(BENCH, cell, False)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert harness.cell_metrics(BENCH, cell, True)


def test_command_stays_in_paths():
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
