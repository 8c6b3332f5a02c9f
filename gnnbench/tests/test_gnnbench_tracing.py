"""The reading of a profiler trace, on a trace made by hand (times in
microseconds)."""

from __future__ import annotations

from gnnbench import tracing


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_by_hand():
    trace = {"traceEvents": [
        ev(tracing.WINDOW_TAG, "user_annotation", 0, 100),
        ev("slab", "kernel", 10, 10),
        ev("residual", "kernel", 15, 15),
        ev("slab", "kernel", 50, 10),
        ev("Memset", "gpu_memset", 70, 5),
        ev("cudaGraphLaunch", "cuda_runtime", 35, 10),
        ev("late", "kernel", 150, 10),
        {"ph": "s", "name": "flow", "ts": 1},
    ]}
    s = tracing.summarize(trace, steps=2)
    assert s.kernels == 3
    assert abs(s.busy_s - 35e-6) < 1e-12
    assert abs(s.window_s - 100e-6) < 1e-12
    assert [n for n, _ in s.device_ops] == ["slab", "residual", "Memset"]
    assert [round(t * 1e6, 6) for _, t in s.idle_gaps] == [25, 20, 10, 10]
    assert s.idle_gaps[1][0] == "cudaGraphLaunch"
    assert s.idle_gaps[0][0] == "no host operation traced"
    assert s.kernel_s == {"slab": 20e-6, "residual": 15e-6}


def test_aggregation_kernels_by_namespace():
    trace = {"traceEvents": [
        ev(tracing.WINDOW_TAG, "user_annotation", 0, 100),
        ev("void gnna::slab_stream_kernel<unsigned short>(int)", "kernel",
           10, 10),
        ev("void gnna::residual_t_kernel<float, 3>(int)", "kernel", 30, 6),
        ev("sm80_xmma_gemm_f32f32", "kernel", 40, 20),
    ]}
    s = tracing.summarize(trace, steps=2)
    assert abs(tracing.agg_step_s(s) - 8e-6) < 1e-12
    assert tracing.agg_step_s(tracing.summarize(
        {"traceEvents": trace["traceEvents"][:1]}, steps=2)) is None
