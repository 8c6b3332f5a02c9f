"""Training loop and timing protocol (reference GNNA_main.py:177-203).

The port of ``gnnadvisor_osdi21_tpu/train.py:34-55, 158-328``:

- Adam, lr 0.01, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8),
  which ``torch.optim.Adam`` computes the same way;
- loss = masked NLL of the log-softmax outputs; the hybrid layout's
  padding rows are masked out;
- a few dry-run epochs, then timed epochs fenced with CUDA events.

Models: the 2-layer GCN and the 5-layer GIN, on a transposed or a
row-major hybrid layout.  Not ported yet: the JAX package's whole-run
``lax.scan`` and its chunked timing (whose analog here, CUDA-graph
capture of the step, is ROADMAP.md item A.6), checkpoint/resume (item
A.6), and the ELL, dense and COO layouts (item A.4).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN
from gnnadvisor_osdi21_tpu_torch.models.gin import GIN
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import (
    exact_f32_matmul, is_transposed,
)
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import HybridTensors


MODELS = {"gcn": GCN, "gin": GIN}


def nll_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    transposed: bool = True,
) -> torch.Tensor:
    """Mean negative log-likelihood (F.nll_loss, reduction='mean') of the
    log_probs over the rows where ``mask`` is 1.  ``transposed``: log_probs
    is ``[classes, N]`` (the port's default layout), else ``[N,
    classes]``."""
    labels = labels.to(torch.int64)
    if transposed:
        nll = -log_probs.gather(0, labels[None, :])[0]
    else:
        nll = -log_probs.gather(1, labels[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / mask.sum()


def accuracy(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
    transposed: bool = True,
) -> torch.Tensor:
    """Classification accuracy of the log_probs (``[classes, N]`` when
    ``transposed``, else ``[N, classes]``) over the (optionally masked)
    rows."""
    pred = log_probs.argmax(dim=0 if transposed else 1)
    hit = (pred == labels.to(pred.dtype)).to(torch.float32)
    if mask is None:
        return hit.mean()
    m = mask.to(torch.float32)
    return (hit * m).sum() / m.sum().clamp(min=1.0)


def train_and_time(
    model: str,
    hts: Sequence[HybridTensors],
    x,
    y,
    hidden: int,
    num_classes: int,
    num_epochs: int = 200,
    dry_run: int = 10,
    lr: float = 0.01,
    seed: int = 0,
    mask=None,
    device=None,
    init_params: Mapping[str, np.ndarray] | None = None,
) -> dict:
    """Train ``model`` ("gcn" or "gin") for ``dry_run`` + ``num_epochs``
    full-graph steps; return the losses of every step and ``epoch_ms``, the
    mean time of a timed epoch between two CUDA events.  On the CPU
    (``device="cpu"``), or with no timed epochs, nothing is timed and
    ``epoch_ms`` is None.

    ``x`` [R, D] row-major features and ``y`` [R] labels in the layout's
    padded row space; ``mask`` [R] (1 on real rows).  ``init_params``
    carries JAX weights across (``params_from_jax``); otherwise the
    weights come from a ``torch.Generator`` seeded with ``seed``."""
    if model not in MODELS:
        raise ValueError(f"unknown model: {model}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_f32_matmul()
    net = MODELS[model](
        x.shape[1], hidden, num_classes,
        generator=torch.Generator().manual_seed(seed), device=dev,
    )
    if init_params is not None:
        net.params_from_jax(init_params)
    transposed = is_transposed(hts[0])
    x = torch.as_tensor(x, dtype=torch.float32)
    if transposed:
        x = x.t()  # the transposed layout wants [D, R]: once, at setup
    x = x.contiguous().to(dev)
    labels = torch.as_tensor(y).to(dev, torch.int64)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        loss = nll_loss(net(x, hts), labels, mask, transposed)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(dry_run)]
    epoch_ms = None
    if dev.type == "cuda" and num_epochs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        losses += [step() for _ in range(num_epochs)]
        end.record()
        end.synchronize()
        epoch_ms = start.elapsed_time(end) / num_epochs
    else:
        losses += [step() for _ in range(num_epochs)]
    loss_values = torch.stack(losses).tolist() if losses else []
    return {
        "epoch_ms": epoch_ms,
        "losses": loss_values,
        "final_loss": loss_values[-1] if loss_values else None,
        "num_epochs": num_epochs,
        "dry_run": dry_run,
        "model": net,
    }
