"""Independent GNN stacks the tuned port is measured against
(``bench/baseline_campaign.py``), and their timing protocol."""

from __future__ import annotations

import time

import torch


def time_steps(step, device: torch.device, epochs: int,
               stats: dict | None = None) -> float:
    """Milliseconds per ``step()`` (a training step returning its loss):
    10 warm-up steps, then the host's wall time over ``epochs`` steps,
    fenced by a ``torch.cuda.synchronize`` on the card (the JAX
    baselines' host-fence timing).  ``stats``, when given, receives
    ``first_loss``: the first step's loss, before any update."""
    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    first = step()
    for _ in range(9):
        step()
    if stats is not None:
        stats["first_loss"] = float(first.detach())
    fence()
    t0 = time.perf_counter()
    for _ in range(epochs):
        step()
    fence()
    return (time.perf_counter() - t0) * 1e3 / epochs
