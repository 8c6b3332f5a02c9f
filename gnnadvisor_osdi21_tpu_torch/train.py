"""Training loop and timing protocol (reference GNNA_main.py:177-203).

The port of ``gnnadvisor_osdi21_tpu/train.py:34-55, 158-328``:

- Adam, lr 0.01, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8),
  which ``torch.optim.Adam`` computes the same way;
- loss = masked NLL of the log-softmax outputs; the hybrid layout's
  padding rows are masked out;
- a few dry-run epochs, then the reference's scan-mode timing protocol
  (train.py:205-283 there): windows of ``chunk`` epochs, each fenced by
  two CUDA events, and a two-point marginal fit against windows of
  ``chunk // 8`` epochs.

Models: the 2-layer GCN and the 5-layer GIN, on a transposed or a
row-major hybrid layout or on the ELL, dense and COO tensors (row-major,
no padding rows).  Not ported yet: CUDA-graph capture of the step (the
analog of the JAX package's whole-run ``lax.scan``) and checkpoint/resume
(ROADMAP.md item A.6).
"""

from __future__ import annotations

import statistics
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN
from gnnadvisor_osdi21_tpu_torch.models.gin import GIN
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import (
    exact_f32_matmul, is_transposed,
)
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import GraphTensors
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


MIN_WINDOWS = 8  # timed windows of each size


def train_and_time(
    model: str,
    hts: Sequence[HybridTensors] | Sequence[GraphTensors],
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
    """Train ``model`` ("gcn" or "gin") full-graph and time its epochs
    with the reference protocol.

    ``dry_run`` warm-up epochs run first.  On the card, the timed epochs
    then run in windows, one window being ``chunk`` epochs between two
    CUDA events: ``chunk = max(1, num_epochs // 8)``, so that at least 8
    windows cover ``num_epochs`` (the reference sizes its chunk from a TPU
    execution limit that does not exist here).  ``n_exec =
    max(8, ceil(num_epochs / chunk))`` windows of ``chunk`` epochs run,
    then, when ``chunk >= 8``, ``n2 = max(8, min(16, n_exec))`` windows of
    ``chunk2 = chunk // 8``.  With the medians ``med1`` and ``med2`` of
    the two sets, ``epoch_ms`` is the slope ``(med1 - med2) / (chunk -
    chunk2)`` and ``exec_fixed_ms`` the intercept, what every window pays
    once; where the slope is not positive (noise inverting the fit), or
    without the second set, ``epoch_ms`` is the mean over the ``chunk``
    windows and ``exec_fixed_ms`` 0.  ``num_epochs`` in the result is the
    count of timed epochs, ``n_exec·chunk``; the second set's epochs count
    as warm-up in ``step``.

    On the CPU (``device="cpu"``) nothing is timed: the ``dry_run +
    num_epochs`` steps run and ``epoch_ms`` is None.

    ``x`` [R, D] row-major features and ``y`` [R] labels in the tensors'
    row space (``InputProperty.pad_features``: the hybrid layout's padded
    rows, the graph's N rows otherwise); ``mask`` [R] (1 on real rows;
    None for the ELL, dense and COO tensors, which have no padding).  ``init_params``
    carries JAX weights across (``params_from_jax``); otherwise the
    weights come from a ``torch.Generator`` seeded with ``seed``.

    Returns the reference's keys (``epoch_ms``, ``dispatch_ms`` = 0.0,
    ``exec_fixed_ms``, ``warmup_s``, ``final_loss``, ``num_epochs``,
    ``step``) and ``losses`` (every step's), ``dry_run``, ``model``,
    ``chunk``, ``chunk2`` and ``window_ms`` / ``window2_ms`` (each
    window's ms, empty off the card)."""
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
    losses: list[torch.Tensor] = []

    def step() -> None:
        opt.zero_grad(set_to_none=True)
        loss = nll_loss(net(x, hts), labels, mask, transposed)
        loss.backward()
        opt.step()
        losses.append(loss.detach())

    t0 = time.perf_counter()
    for _ in range(dry_run):
        step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warmup_s = time.perf_counter() - t0

    epoch_ms, exec_fixed_ms = None, 0.0
    chunk = chunk2 = 0
    window_ms: list[float] = []
    window2_ms: list[float] = []
    if dev.type == "cuda" and num_epochs:
        chunk, n_exec, chunk2, n2 = timing_plan(num_epochs)
        window_ms = [_window_ms(step, chunk) for _ in range(n_exec)]
        window2_ms = [_window_ms(step, chunk2) for _ in range(n2)]
        epoch_ms, exec_fixed_ms = marginal_fit(
            window_ms, window2_ms, chunk, chunk2
        )
        num_epochs = n_exec * chunk
    else:
        for _ in range(num_epochs):
            step()
    loss_values = torch.stack(losses).tolist() if losses else []
    return {
        "epoch_ms": epoch_ms,
        "dispatch_ms": 0.0,
        "exec_fixed_ms": exec_fixed_ms,
        "warmup_s": warmup_s,
        "final_loss": loss_values[-1] if loss_values else None,
        "num_epochs": num_epochs,
        "step": len(loss_values),
        "losses": loss_values,
        "dry_run": dry_run,
        "model": net,
        "chunk": chunk,
        "chunk2": chunk2,
        "window_ms": window_ms,
        "window2_ms": window2_ms,
    }


def timing_plan(num_epochs: int) -> tuple[int, int, int, int]:
    """(chunk, n_exec, chunk2, n2) for ``num_epochs`` timed epochs (the
    rule in ``train_and_time``'s docstring); n2 is 0 without a fit."""
    chunk = max(1, num_epochs // MIN_WINDOWS)
    n_exec = max(MIN_WINDOWS, -(-num_epochs // chunk))
    chunk2 = chunk // 8
    n2 = max(MIN_WINDOWS, min(16, n_exec)) if chunk2 >= 1 else 0
    return chunk, n_exec, chunk2, n2


def marginal_fit(
    window_ms: Sequence[float], window2_ms: Sequence[float], chunk: int,
    chunk2: int,
) -> tuple[float, float]:
    """(epoch_ms, exec_fixed_ms) from the windows of ``chunk`` and
    ``chunk2`` epochs: the slope and intercept through the two medians
    (gnnadvisor_osdi21_tpu/train.py:263-272), or the plain mean per epoch
    and 0 without a second set or where noise inverts the fit."""
    mean = statistics.fmean(window_ms) / chunk
    if not window2_ms:
        return mean, 0.0
    med1 = statistics.median(window_ms)
    med2 = statistics.median(window2_ms)
    marg = (med1 - med2) / (chunk - chunk2)
    if marg <= 0:  # guard: noise can invert the fit
        return mean, 0.0
    return marg, max(med1 - chunk * marg, 0.0)


def _window_ms(step, n: int) -> float:
    """Milliseconds of ``n`` training steps between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)
