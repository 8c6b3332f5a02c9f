"""Device timing of chained ops: the port of
``gnnadvisor_osdi21_tpu/utils/timing.py``.

The JAX helpers chain ``iters`` executions of an op inside one jitted
``fori_loop``, feeding a scalar of each output back into the next input:
that defeats XLA's common-subexpression elimination and loop hoisting.
Eager PyTorch does neither, so here the ``iters`` calls of ``op(x, aux)``
are issued back to back and the stream's order serializes them.  A run is
fenced by two ``torch.cuda.Event``s on the current stream; its time is the
events' elapsed time.  Operands on the CPU time with ``time.perf_counter``
around the same loop (what the CPU tests drive).

Each helper keeps the reference's signature and return value.  A
``stats`` dict, when given, receives ``host_s``: the host's wall time to
issue one op, the least over the timed runs.  An op that takes the host
longer to issue than the card to run (each PyTorch call costs the host
microseconds) measures the host's launch rate, and the two-point fit
does not remove a per-iteration cost; ``host_s`` close to the device
time shows that.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from gnnadvisor_osdi21_tpu_torch.device import resolve_device

_now = time.perf_counter  # the host clock (a test may replace it)


def _call(op: Callable, x, aux):
    return op(x, aux) if aux is not None else op(x)


def _device_of(x) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    raise TypeError("x must be a torch.Tensor")


def _run(op: Callable, x, aux, n: int) -> tuple[float, float]:
    """(seconds for ``n`` chained calls, host seconds to issue them)."""
    if _device_of(x).type != "cuda":
        t0 = _now()
        for _ in range(n):
            _call(op, x, aux)
        t = _now() - t0
        return t, t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = _now()
    for _ in range(n):
        _call(op, x, aux)
    host = _now() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, host


def _timed(op: Callable, x, aux, n: int, reps: int, warmup: int,
           host: list) -> float:
    """Least seconds over ``reps`` runs of ``n`` calls, after ``warmup``
    untimed runs; appends the least host issue time to ``host``."""
    for _ in range(warmup):
        _run(op, x, aux, n)
    best = best_host = float("inf")
    for _ in range(reps):
        t, h = _run(op, x, aux, n)
        best, best_host = min(best, t), min(best_host, h)
    host.append(best_host)
    return best


def chained_device_time(
    op: Callable,
    x: torch.Tensor,
    aux=None,
    iters: int = 50,
    reps: int = 3,
    warmup: int = 1,
    stats: dict | None = None,
) -> float:
    """Mean seconds per op execution: the least of ``reps`` runs of
    ``iters`` chained calls ``op(x, aux)``, after ``warmup`` runs."""
    host: list[float] = []
    best = _timed(op, x, aux, iters, reps, warmup, host)
    if stats is not None:
        stats["host_s"] = host[0] / iters
    return best / iters


def chained_marginal_time(
    op: Callable,
    x: torch.Tensor,
    aux=None,
    iters: int = 200,
    reps: int = 3,
    quad: int = 4,
    stats: dict | None = None,
) -> tuple[float, float]:
    """(marginal seconds per op execution, fixed seconds per run).

    Two-point fit: time runs of ``iters`` and ``quad·iters`` chained calls
    (each point the least of ``reps`` runs after one warm-up run) and
    report the slope and the intercept.  The intercept is what every run
    pays once (the fence, the first launch's ramp), which a single point
    would smear over its iterations."""
    host: list[float] = []
    t1 = _timed(op, x, aux, iters, reps, 1, host)
    t2 = _timed(op, x, aux, quad * iters, reps, 1, host)
    marginal = (t2 - t1) / ((quad - 1) * iters)
    fixed = max(t1 - marginal * iters, 0.0)
    if stats is not None:
        stats["host_s"] = host[1] / (quad * iters)
    return marginal, fixed


def dispatch_floor(iters: int = 50, reps: int = 3, device=None) -> float:
    """Per-call host cost of an asynchronous loop of trivial ops fenced
    only at the end: what a per-epoch loop pays per step even for a no-op
    step.  ``device`` None is the card; the least over ``reps`` runs."""
    dev = resolve_device(device)
    s = torch.zeros((), device=dev)
    s = s + 1.0
    best = float("inf")
    for _ in range(reps):
        t0 = _now()
        for _ in range(iters):
            s = s + 1.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, _now() - t0)
    return best / iters
