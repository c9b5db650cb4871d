"""portbench/spans.py on a hand-made trace: kernels land in the stage of
their launch and gaps in the stage at their midpoint, the innermost stage
span winning, a sync.* span counting as its parent and a span of
autograd's thread inside `*.backward` winning over it; the idle of the
stages sums to the window's; a synchronize outside every sync.* span is
unmarked; a trace without stage spans reads nothing."""
import types

import pytest

from portbench import harness, spans
from portbench.tracing import Trace

RT, UA = "cuda_runtime", "user_annotation"


def host(start, end, name, cat=UA, corr=-1):
    return (float(start), float(end - start), name, cat, corr)


def kernel(start, end, corr):
    return (float(start), float(end - start), "k", "kernel", corr)


def step_trace(with_spans=True):
    """One 250 us step: the harness's synchronize ends at 0; the render
    [0, 100) (preprocess, then binning with its sync), the backward
    [100, 200) with a blend backward [120, 150) of autograd's thread, an
    unwrapped stream synchronize at 160."""
    names = [host(0, 100, "vanilla.render_and_loss"),
             host(10, 30, "render.preprocess"),
             host(30, 50, "render.binning"),
             host(32, 38, "sync.binning"),
             host(100, 200, "vanilla.backward"),
             host(120, 150, "render.blend_backward")] if with_spans else []
    runtime = [host(-5, 0, "cudaDeviceSynchronize", RT),
               host(12, 13, "cudaLaunchKernel", RT, 1),
               host(33, 34, "cudaMemcpyAsync", RT, 2),
               host(34, 37, "cudaStreamSynchronize", RT),
               host(39, 40, "cudaLaunchKernel", RT, 3),
               host(125, 126, "cudaLaunchKernel", RT, 4),
               host(160, 170, "cudaStreamSynchronize", RT),
               host(175, 176, "cudaLaunchKernel", RT, 5)]
    device = [kernel(20, 25, 1), kernel(34, 35, 2), kernel(45, 60, 3),
              kernel(130, 140, 4), kernel(180, 190, 5)]
    return Trace(device, names + runtime)


def ctx_of(trace):
    return types.SimpleNamespace(trace=trace, traced_steps=1,
                                 traced_s=250e-6)


def read(name, ctx):
    return harness.metric_reader(name).read(ctx)


def test_kernels_land_in_the_stage_of_their_launch():
    ctx = ctx_of(step_trace())
    assert spans.device_ms(ctx, "preprocess") == pytest.approx(5e-3)
    # the copy launched inside sync.binning is binning's
    assert spans.device_ms(ctx, "binning") == pytest.approx(16e-3)
    # launched on autograd's thread inside vanilla.backward: blend wins
    assert spans.device_ms(ctx, "blend") == pytest.approx(10e-3)
    assert spans.device_ms(ctx, "backward") == pytest.approx(10e-3)
    assert read("device.loop_ms", ctx) == 0.0


def test_gaps_land_in_the_stage_at_their_midpoint():
    ctx = ctx_of(step_trace())
    idle = {s: spans.idle_ms(ctx, s) * 1e3 for s in spans.STAGES}
    # [0, 20): midpoint 10 is the preprocess span's start
    assert idle["preprocess"] == pytest.approx(20 + 9)      # + [25, 34)
    # [35, 45): midpoint 40 in render.binning
    assert idle["binning"] == pytest.approx(10)
    # [60, 130): midpoint 95 in vanilla.render_and_loss, no stage: loop;
    # [140, 180): midpoint 160 in the backward; [190, 250): loop
    assert idle["blend"] == 0.0
    assert idle["backward"] == pytest.approx(40)
    assert idle["loop"] == pytest.approx(70 + 60)


def test_the_idle_of_the_stages_sums_to_the_windows():
    ctx = ctx_of(step_trace())
    total = sum(read(f"idle.{s}_ms", ctx) for s in spans.STAGES)
    idle_pct = read("device_idle_pct", ctx)
    assert total == pytest.approx(idle_pct / 100 * 250e-3)
    assert total == pytest.approx((250 - 41) * 1e-3)


def test_syncs_are_counted_and_unwrapped_ones_unmarked():
    ctx = ctx_of(step_trace())
    assert read("host_syncs_per_step", ctx) == 1
    assert read("host_sync_wait_ms", ctx) == pytest.approx(6e-3)
    # the synchronize at 34 lies in sync.binning, the one at 160 in none
    assert read("unmarked_syncs_per_step", ctx) == 1


@pytest.mark.parametrize("name", ["idle.loop_ms", "device.blend_ms",
                                  "dataio.host_ms", "host_syncs_per_step",
                                  "host_sync_wait_ms",
                                  "unmarked_syncs_per_step"])
def test_a_trace_without_stage_spans_reads_nothing(name):
    assert read(name, ctx_of(step_trace(with_spans=False))) is None
    assert read(name, types.SimpleNamespace(trace=None, traced_steps=0,
                                            traced_s=0.0)) is None


def test_stage_names():
    assert spans.stage_of("scaffold.prefilter") == "prefilter"
    assert spans.stage_of("pgsr.adam") == spans.stage_of("vanilla.stats") \
        == "update"
    assert spans.stage_of("vanilla.render_and_loss") is None
    assert spans.stage_of("sync.decode") is None
    assert spans.stage_of("aten::mul") is None
    assert spans.is_wait("cudaMemcpy") and spans.is_wait(
        "cudaEventSynchronize")
    assert not spans.is_wait("cudaMemcpyAsync")
    assert not spans.is_wait("cudaDeviceSynchronize")
