"""The operation and byte counts, and the trace reader, against values worked
out by hand."""
import json

import pytest
import torch

from portbench import counts, harness, tracing

ref = harness.load_module(harness.HERE / "reference" / "gs3d.py")


def one_tile(ops):
    """A 16 x 16 render of gaussians whose conic is 0, so that every pixel
    sees alpha = op: attrs [N, 9] and the tile's list in order."""
    n = len(ops)
    attrs = torch.zeros(n, 9)
    attrs[:, 0:2] = 8.0
    attrs[:, 5] = torch.tensor(ops)
    attrs[:, 6:9] = 0.5
    gid = torch.arange(n)
    start = torch.tensor([0, n])
    return attrs, gid, start


def test_two_gaussians_both_contribute():
    # T: 1 -> 0.5 -> 0.25, both above 1e-4: 2 x 256 pairs, 2 instances
    assert ref.screen_pair_counts(*one_tile([0.5, 0.5]), 1) == (512, 2)
    w = counts.vanilla_step(512, 2, 2, 2, 16, 16)
    assert w["blend_fwd"] == {"ops": 28 * 512, "bytes": 2 * 36 + 256 * 16}
    assert w["blend_bwd"] == {"ops": 56 * 512,
                              "bytes": 2 * 2 * 36 + 2 * 256 * 16}
    assert w["step"]["ops"] == (84 * 512 + (5 * 2 * 2 * 11 * 3 + 40) * 768
                                + 12 * 59 * 2 + 750 * 2)


def test_saturation_ends_the_list():
    # op 0.95: T 0.05, 0.0025, 1.25e-4; the fourth would take it to
    # 6.25e-6 < 1e-4 and holds no pair, so it is no instance either
    assert ref.screen_pair_counts(*one_tile([0.95] * 4), 1) == (768, 3)


def test_transparent_gaussian_is_no_pair():
    # 255 x 0.003 < 1: alpha under 1/255 everywhere
    assert ref.screen_pair_counts(*one_tile([0.003, 0.5]), 1) == (256, 1)


def test_least_seconds_takes_the_slower_bound():
    assert counts.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(67e9, 6.7e9) == pytest.approx(2e-3)


def test_trace_busy_gaps_and_launched_kernels(tmp_path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::cummax", "ts": 0,
         "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 60, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 200, "dur": 5, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "scan_kernel(int)", "ts": 20,
         "dur": 30, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel",
         "name": "(anonymous namespace)::blend_fwd_kernel(float const*)",
         "ts": 40, "dur": 20, "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 150,
         "dur": 10},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    t = tracing.Trace.load(str(p))
    assert t.busy_s() == pytest.approx(50e-6)        # [20, 60] + [150, 160]
    assert t.kernel_seconds("blend_fwd_kernel") == pytest.approx(20e-6)
    assert t.kernel_seconds("fwd_kernel") == 0.0
    assert tracing.is_kernel("void ns::scan_kernel<int>(int*)", "scan_kernel")
    assert t.op_device_seconds("aten::cummax") == pytest.approx(30e-6)
    assert t.host_seconds("aten::cummax") == pytest.approx(50e-6)
    assert len(t.kernels()) == 2
    b = t.breakdown()
    assert b["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(90e-6)]]
    assert b["device_ops"][0] == ["scan_kernel(int)", pytest.approx(30e-6)]
