"""Run one cell of the benchmark once and print one JSON line.

    python3 -m gnnbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the harness's first statement to the first
timed replay): the cell's graph (synthesized once per checkout, then
read from ``gnnbench/_cache/graphs``), the port's decider and layout, the
seeded inputs, the warm-up, the capture and the three first steps the
reference follows.  The window then replays the captured step back to
back for ``--seconds``; ``epoch_ms`` is its elapsed time over its steps.
With ``--trace 1`` a second, profiled window follows, the per-layer
metrics' readers run, and the line carries those metrics in place of the
end-to-end ones.  Once the windows have closed and the card's peak
memory has been read, the program is freed and the plain reference
(``reference.py``) follows the same first steps; ``correct`` is the
comparison of the two (``check.py``).

It runs only on the card: without one, or with fewer cards than the cell
asks for, it exits 2 and prints no result.  It exits 3 and prints no
result if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_cache")
# every build and kernel cache inside the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")

import torch  # noqa: E402

from gnnbench import (  # noqa: E402
    check, data, graphgen, reference, spec, tracing,
)
from gnnbench.program import FIRST_STEPS, Program  # noqa: E402

TRACE_SECONDS = 2.0  # the profiled window of a --trace 1 run
FORBIDDEN = ("jax", "jaxlib", "flax", "gnnadvisor_osdi21_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


class Context:
    """What the per-layer readers read: the cell, the set-up's and the
    windows' times, the trace and the graph's counts."""

    def __init__(self, cell, layout_s: float, on_card: bool):
        self.cell = cell
        self.on_card = on_card
        self.layout_s = layout_s
        self.epoch_ms = None
        self.trace = None
        self.nodes = None
        self.edges = None
        self.widths = cell.model.arch.widths(cell.config, cell.traffic)


def main(argv=None, device=None, root=None) -> int:
    """One run; ``device`` None is the card (the only device a result is
    reported for on the command line); tests pass ``"cpu"`` to drive the
    harness on the port's plain versions, and ``root`` for a checkout
    other than this module's."""
    args = parse(argv)
    cell = spec.Cell(args.workload, root or spec.ROOT)
    cache_dir = os.path.join(cell.here, "_cache")
    if device is None:
        if not torch.cuda.is_available():
            print("error: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"error: the cell asks for {cell.chips} cards, "
                  f"{torch.cuda.device_count()} are visible", file=sys.stderr)
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        print(f"# card: {card_line()}")
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the allocator exists before its reset
        torch.cuda.reset_peak_memory_stats(dev)

    trace_s = TRACE_SECONDS if args.trace else 0.0
    prog = Program.build(cell, args.seed, dev, cache_dir,
                         args.seconds + trace_s)
    setup_s = time.perf_counter() - T_START
    steps, elapsed = tracing.run_window(prog.replay, args.seconds, on_card)
    epoch_ms = elapsed * 1e3 / steps
    print(f"# window: {steps} steps in {elapsed:.6f} s, setup {setup_s:.6f} s")

    ctx = Context(cell, prog.layout_s, on_card)
    ctx.epoch_ms = epoch_ms
    readers = []
    if args.trace:
        os.makedirs(os.path.join(cache_dir, "traces"), exist_ok=True)
        ctx.trace = tracing.traced_window(
            prog.replay, min(TRACE_SECONDS, args.seconds), on_card,
            os.path.join(cache_dir, "traces", f"{cell.name}.json"))
        readers = [(m, cell.reader(m["name"])) for m in cell.per_layer]

    losses = prog.losses()
    window_losses = losses[FIRST_STEPS:FIRST_STEPS + steps]
    failed = sum(not math.isfinite(v) for v in window_losses)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        print(f"# peak device memory: {peak} bytes")
    readings = prog.readings
    prog.free()
    del prog
    gc.collect()

    # the reference, alone on the card
    traffic = cell.traffic
    src, dst, n = graphgen.read_edges(
        graphgen.edge_file(traffic, cache_dir))
    g = reference.Graph(src, dst, n, dev)
    ctx.nodes, ctx.edges = g.n, g.nnz
    x, labels, params0 = data.make_inputs(args.seed, cell.model, traffic, dev)
    ref = reference.follow(cell.model, g, x, labels, params0, FIRST_STEPS)
    del g, x, labels, params0
    numbers = check.compare(readings, ref)
    correct = check.verdict(numbers, cell.limits) and failed == 0

    if args.trace:
        metrics = {}
        for m, mod in readers:
            value = mod.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"epoch_ms": epoch_ms, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {
        "correct": bool(correct),
        "attempted": steps,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if args.trace:
        t = ctx.trace
        result["device"]["busy_s"] = t.busy_s
        result["device"]["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.device_ops,
                               "idle_gaps": t.idle_gaps}
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                  "limit": v}
              for k, v in cell.limits.items()}
    checks["window_nonfinite_losses"] = {"value": failed, "limit": 0}
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"error: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in checks.items():
        value = numbers.get(k, v["value"])
        print(f"check {k}: {value!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
