"""The measured windows and the reading of the profiler's trace.

``run_window`` replays the step back to back for a number of seconds,
with at most ``LAG`` replays queued ahead of the card, so that the
window ends within a few steps of its deadline; its time is the host
clock from a synchronise before the first replay to a synchronise after
the last.  ``traced_window`` runs the same loop under ``torch.profiler``
and reads the Chrome trace it writes: kernels and the device's busy time
(the union of the intervals in which any operation ran on the card), the
operations that took the most time, and the longest idle gaps by what
the host was doing.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable

import torch

LAG = 8  # replays queued ahead of the card at most
WINDOW_TAG = "gnnbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")
TOP = 10
_NAME_CHARS = 160
# the aggregation's kernels: the port's own, in the namespace of its CUDA
# sources (the slab tiers and the residual)
AGG_KERNELS = "gnna::"


def run_window(replay: Callable[[], None], seconds: float,
               on_card: bool) -> tuple[int, float]:
    """(steps, elapsed seconds) of ``replay()`` called back to back until
    ``seconds`` have passed, every step counted and waited for."""
    events = [torch.cuda.Event() for _ in range(LAG)] if on_card else []
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    n = 0
    while True:
        replay()
        if on_card:
            ev = events[n % LAG]
            if n >= LAG:
                ev.synchronize()  # the replay LAG steps back has finished
            ev.record()
        n += 1
        if time.perf_counter() >= deadline:
            break
    if on_card:
        torch.cuda.synchronize()
    return n, time.perf_counter() - t0


@dataclasses.dataclass
class TraceSummary:
    steps: int
    window_s: float
    busy_s: float
    kernels: int  # kernel launches seen on the card in the window
    kernel_s: dict  # {kernel name: seconds in the window}, every kernel
    device_ops: list  # [[name, seconds], ...] the most time, summed by name
    idle_gaps: list  # [[host op, seconds], ...] the longest gaps


def traced_window(replay: Callable[[], None], seconds: float, on_card: bool,
                  path: str) -> TraceSummary:
    """``run_window`` under ``torch.profiler``; the Chrome trace goes to
    ``path`` (overwritten) and is read back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_TAG):
            steps, _ = run_window(replay, seconds, on_card)
    prof.export_chrome_trace(path)
    with open(path) as fp:
        trace = json.load(fp)
    return summarize(trace, steps)


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(trace: dict, steps: int) -> TraceSummary:
    """Reduce a Chrome trace (times in microseconds) to the window's
    numbers; only what falls inside the window's annotation counts."""
    spans = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in spans if e.get("name") == WINDOW_TAG
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW_TAG!r} annotation")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    dev, host, kernels, by_name, kernel_s = [], [], 0, {}, {}
    for e in spans:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if b <= w0 or a >= w1:
            continue
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            dev.append((a, b))
            if cat == "kernel":
                kernels += 1
                full = str(e.get("name"))
                kernel_s[full] = kernel_s.get(full, 0.0) + (b - a) / 1e6
            name = str(e.get("name"))[:_NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        elif cat in HOST_CATS and e is not windows[0]:
            host.append((a, b, str(e.get("name"))[:_NAME_CHARS]))
    busy = _union(dev)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:TOP]:
        mid = (a + b) / 2
        around = [h for h in host if h[0] <= mid <= h[1]]
        name = (min(around, key=lambda h: h[1] - h[0])[2] if around
                else "no host operation traced")
        idle.append([name, (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        steps=steps,
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernels=kernels,
        kernel_s=kernel_s,
        device_ops=[[k, v / 1e6] for k, v in ops],
        idle_gaps=idle,
    )


def agg_step_s(trace: TraceSummary | None) -> float | None:
    """Seconds a step spends in the aggregation's kernels (``AGG_KERNELS``)
    in a traced window, or None where it ran none."""
    if trace is None or not trace.steps:
        return None
    total = sum(s for name, s in trace.kernel_s.items() if AGG_KERNELS in name)
    return total / trace.steps if total > 0 else None
