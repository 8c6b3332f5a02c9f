"""Profiling, the port's spans and counters, and roofline accounting: the
port of ``gnnadvisor_osdi21_tpu/utils/profiling.py``.

The reference's profiling is cudaEvent timing plus GFLOPs printouts
behind ``#ifdef PROFILE`` (GNNAdvisor_kernel.cu:134-175); here it is a
``torch.profiler`` trace plus roofline accounting against the card's
memory rate.  The peaks are one NVIDIA H100 SXM's, from NVIDIA's data
sheet (dense rates, no sparsity, at the full 700 W power limit); the JAX
package's are a TPU v5e's and do not apply here.

Spans and counters (``STORE``, through ``span`` and ``count``): every
span records its name, its parent, its start and end on the host's
monotonic clock (``time.perf_counter_ns``) and its attributes, into a
bounded buffer that keeps the newest records and counts those it drops.
While a ``torch.profiler`` is active a span also opens
``record_function(name)``, so it appears in the Chrome trace as a
``user_annotation``; ``trace_us`` maps the store's clock onto that
trace's ``ts``.  Inside ``device_timed`` every span also records a CUDA
event at its start and end, and gets the device seconds between them
(``device_s``).  Set-up spans stay on (two clock reads against seconds
of work); the captured step's replay opens one only under a profiler.
``format_tree`` prints a span's tree with self times and the counters
(the CLI's ``--verbose_mode True``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time
from collections.abc import Callable, Iterable, Iterator, MutableMapping

import torch

# H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core rate, f32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# traces go into the port's git-ignored cache directory unless told
_TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache",
    "trace")


@dataclasses.dataclass
class RooflineReport:
    seconds: float
    bytes_accessed: int
    flops: int

    @property
    def achieved_gbs(self) -> float:
        return self.bytes_accessed / self.seconds / 1e9

    @property
    def hbm_fraction(self) -> float:
        return self.bytes_accessed / self.seconds / HBM_BYTES_PER_S

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    def __str__(self) -> str:
        return (
            f"{self.seconds * 1e3:.3f} ms | {self.achieved_gbs:.0f} GB/s "
            f"({self.hbm_fraction * 100:.0f}% of HBM) | "
            f"{self.achieved_tflops:.2f} TFLOP/s"
        )


def spmm_roofline(seconds: float, nnz: int, dim: int, num_nodes: int,
                  dtype_bytes: int = 4) -> RooflineReport:
    """Roofline for one SpMM: must read every neighbor row once and write
    every output row once (the information-theoretic floor)."""
    bytes_accessed = (nnz + num_nodes) * dim * dtype_bytes
    return RooflineReport(seconds, bytes_accessed, 2 * nnz * dim)


@contextlib.contextmanager
def trace(log_dir: str = _TRACE_DIR):
    """``torch.profiler`` trace of the block, host and card, written as a
    Chrome trace into ``log_dir`` (open it in Perfetto or
    chrome://tracing); yields the profiler."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


# --- spans and counters ----------------------------------------------------

CAPACITY = 1 << 15  # closed spans kept; the oldest go first
# a hold of s seconds sleeps s times the H100's top SM clock in cycles, so
# that it lasts no less at a lower clock
SLEEP_CYCLES_PER_S = 1.98e9


class Record:
    """One closed span.  ``start_ns``/``end_ns``: ``time.perf_counter_ns``
    (CLOCK_MONOTONIC); ``parent``: the id of the span open around it
    (None at the top); ``device_s``: the card's seconds between its two
    events, for a span closed inside ``device_timed`` (None otherwise)."""

    __slots__ = ("id", "parent", "name", "attrs", "start_ns", "end_ns",
                 "device_s")

    def __init__(self, id: int, name: str, attrs: dict):
        self.id = id
        self.parent = None
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = 0
        self.device_s = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Span:
    """The context manager ``Store.span`` returns; entering it yields the
    ``Record`` it fills."""

    __slots__ = ("store", "rec", "annotation", "events")

    def __init__(self, store: "Store", name: str, attrs: dict):
        self.store = store
        self.rec = Record(next(store._ids), name, attrs)
        self.annotation = None
        self.events = None

    def __enter__(self) -> Record:
        store, rec = self.store, self.rec
        if store._open:
            rec.parent = store._open[-1].id
        store._open.append(rec)
        if profiler_active():
            self.annotation = torch.autograd.profiler.record_function(
                rec.name)
            self.annotation.__enter__()
        if store._timing is not None:
            self.events = store._timing.start(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        store, rec = self.store, self.rec
        rec.end_ns = time.perf_counter_ns()
        if self.events is not None:
            end, stream = self.events
            end.record(stream)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if store._open[-1] is rec:
            store._open.pop()
        else:  # closed out of order, by another thread
            store._open.remove(rec)
        store.records.append(rec)
        store.closed += 1
        return False


class _Timing:
    """The CUDA events of the spans opened inside ``device_timed``, all on
    the stream it started on (the autograd engine's thread runs the
    backward on the forward's stream, which it may not name current)."""

    def __init__(self, stream):
        self.stream = stream
        self.pairs: list[tuple[Record, torch.cuda.Event,
                               torch.cuda.Event]] = []

    def start(self, rec: Record):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(self.stream)
        self.pairs.append((rec, start, end))
        return end, self.stream


class Store:
    """Spans and counters of one process.  One stack of open spans serves
    every thread: the autograd engine runs a backward's spans on its own
    thread while the caller waits in ``backward()``, so they nest under
    the caller's span."""

    def __init__(self, capacity: int = CAPACITY):
        self.records: collections.deque[Record] = collections.deque(
            maxlen=capacity)
        self.closed = 0  # spans closed, kept or dropped
        self.counters: dict[str, int] = {}
        self._open: list[Record] = []
        self._ids = itertools.count(1)
        self._timing: _Timing | None = None

    @property
    def dropped(self) -> int:
        return self.closed - len(self.records)

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    # -- reading ------------------------------------------------------------

    def latest(self, name: str) -> Record | None:
        """The most recently closed span of that name still kept."""
        for rec in reversed(self.records):
            if rec.name == name:
                return rec
        return None

    def children(self, rec: Record) -> list[Record]:
        """The spans opened directly inside ``rec``, in order."""
        kids = [r for r in self.records if r.parent == rec.id]
        return sorted(kids, key=lambda r: r.start_ns)

    def descendants(self, rec: Record) -> list[Record]:
        """Every span opened inside ``rec``, at any depth, in order of
        start."""
        by_id = {r.id: r for r in self.records}
        out = []
        for r in self.records:
            p = r.parent
            while p is not None and p != rec.id:
                up = by_id.get(p)
                p = None if up is None else up.parent
            if p is not None:
                out.append(r)
        return sorted(out, key=lambda r: r.start_ns)

    def self_s(self, rec: Record) -> float:
        """``rec``'s seconds less the part of them its children cover."""
        return _self_s(rec, self.children(rec))


def _self_s(rec: Record, kids: list[Record]) -> float:
    """``rec``'s seconds less the union of ``kids``' intervals (in order of
    start) inside it."""
    covered, edge = 0, rec.start_ns
    for c in kids:
        a, b = max(c.start_ns, edge), min(c.end_ns, rec.end_ns)
        if b > a:
            covered += b - a
            edge = b
    return (rec.end_ns - rec.start_ns - covered) / 1e9


STORE = Store()


def span(name: str, **attrs) -> _Span:
    """``with span(name, **attrs) as rec:`` records the block in ``STORE``."""
    return STORE.span(name, **attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``STORE``'s counter ``name``."""
    STORE.count(name, n)


def profiler_active() -> bool:
    """True while a ``torch.profiler`` (or the autograd profiler) records."""
    return torch._C._autograd._profiler_enabled()


class CounterView(MutableMapping[str, int]):
    """The store's counters ``<prefix><key>`` for a fixed tuple of keys, as
    a dict: what reads or adds to a key reads or adds to the counter."""

    def __init__(self, prefix: str, keys: Iterable[str],
                 store: Store = STORE):
        self._prefix = prefix
        self._keys = tuple(keys)
        self._store = store

    def __getitem__(self, key: str) -> int:
        if key not in self._keys:
            raise KeyError(key)
        return self._store.counters.get(self._prefix + key, 0)

    def __setitem__(self, key: str, value: int) -> None:
        if key not in self._keys:
            raise KeyError(key)
        self._store.counters[self._prefix + key] = value

    def __delitem__(self, key: str) -> None:
        raise TypeError("a counter cannot be removed")

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))


def device_timed(fn: Callable[[], object], name: str, hold_s: float,
                 on_card: bool = True):
    """Run ``fn()`` once on the card inside span ``name``, with every span
    opened inside (``name``'s too) timed by two CUDA events on the current
    stream; returns what ``fn`` returns.  The stream first sleeps
    ``hold_s`` seconds on the card, so that the host queues the whole of
    ``fn``'s work ahead of it and the intervals are the card's, back to
    back, not the host's rate of launches: the span's attribute ``held``
    says whether the card was still asleep when the host had queued it
    all.  Each span's ``device_s`` is read after a synchronise.
    ``on_card`` False: the span alone, on the host's clock."""
    store = STORE
    if not on_card:
        with store.span(name):
            return fn()
    if store._timing is not None:
        raise RuntimeError("device_timed does not nest")
    stream = torch.cuda.current_stream()
    torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))
    woke = torch.cuda.Event()
    woke.record(stream)
    timing = store._timing = _Timing(stream)
    try:
        with store.span(name, hold_s=hold_s) as rec:
            out = fn()
        rec.attrs["held"] = not woke.query()
    finally:
        store._timing = None
    torch.cuda.synchronize()
    for r, start, end in timing.pairs:
        r.device_s = start.elapsed_time(end) / 1e3
    return out


def clock_offset_ns() -> int:
    """CLOCK_REALTIME less the store's clock, in nanoseconds (from the
    tightest of a few paired reads)."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def trace_us(t_ns: int, trace: dict, offset_ns: int | None = None) -> float:
    """A time of the store's clock as a ``ts`` of ``trace``, a Chrome trace
    that ``torch.profiler`` exported: the profiler stamps its events with
    the Unix time in microseconds, less the trace's
    ``baseTimeNanoseconds`` where it has one.  ``offset_ns``:
    ``clock_offset_ns()``, read now when None."""
    if offset_ns is None:
        offset_ns = clock_offset_ns()
    base = int(trace.get("baseTimeNanoseconds", 0))
    return (t_ns + offset_ns - base) / 1e3


def format_tree(roots: Iterable[Record],
                store: Store | None = None) -> list[str]:
    """Lines of the trees under ``roots``: each span's seconds, its self
    seconds, its device seconds where timed and its attributes; spans of
    one name under one parent are summed on one line (``xN``).  ``store``:
    the roots' (None: ``STORE``)."""
    store = STORE if store is None else store
    index: dict[int, list[Record]] = collections.defaultdict(list)
    for r in sorted(store.records, key=lambda r: r.start_ns):
        if r.parent is not None:
            index[r.parent].append(r)
    lines: list[str] = []

    def walk(group: list[Record], depth: int) -> None:
        total = sum(r.seconds for r in group)
        own = sum(_self_s(r, index[r.id]) for r in group)
        line = (f"{'  ' * depth}{group[0].name}"
                f"{f' x{len(group)}' if len(group) > 1 else ''}: "
                f"{total:.6f} s, self {own:.6f} s")
        dev = [r.device_s for r in group if r.device_s is not None]
        if dev:
            line += f", device {sum(dev) * 1e3:.4f} ms"
        if len(group) == 1 and group[0].attrs:
            line += " " + " ".join(f"{k}={v}" for k, v in
                                   group[0].attrs.items())
        lines.append(line)
        by_name: dict[str, list[Record]] = {}
        for r in group:
            for c in index[r.id]:
                by_name.setdefault(c.name, []).append(c)
        for kids in by_name.values():
            walk(kids, depth + 1)

    for root in roots:
        walk([root], 0)
    return lines


def format_counters(store: Store | None = None) -> str:
    """The counters that are not zero, and the spans dropped, on a line
    (``store`` None: ``STORE``)."""
    store = STORE if store is None else store
    items = [f"{k} {v}" for k, v in sorted(store.counters.items()) if v]
    items.append(f"spans dropped {store.dropped}")
    return ", ".join(items)
