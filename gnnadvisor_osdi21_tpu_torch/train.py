"""Training loop and timing protocol (reference GNNA_main.py:177-203).

The port of ``gnnadvisor_osdi21_tpu/train.py``:

- Adam, lr 0.01, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8),
  which ``torch.optim.Adam`` computes the same way; on the card it is
  ``capturable`` (its step count and bias correction on the device, in
  f32 as optax's), whether or not the step is captured, so that both of
  ``use_scan``'s paths train alike;
- loss = masked NLL of the log-softmax outputs; the hybrid layout's
  padding rows are masked out;
- a few dry-run epochs, then the reference's scan-mode timing protocol
  (train.py:205-283 there): windows of ``chunk`` epochs, each fenced by
  two CUDA events, and a two-point marginal fit against windows of
  ``chunk // 8`` epochs;
- ``use_scan`` (the JAX default): the JAX package compiles the epoch loop
  into one program (``make_epoch_scan``); here one training step,
  forward, backward and Adam, is captured once as a CUDA graph
  (``make_captured_step``) and the timed epochs replay it, so that the
  host issues one graph launch a step instead of each kernel;
- checkpoint/resume in the JAX package's ``.npz`` schema
  (``utils/checkpoint.py``);
- spans (``utils/profiling.py``): ``optimizer.init``, ``warm_up`` and its
  timed last step ``warm_up.timed_step`` (``warm_up``), ``capture``; in a
  step ``loss``, ``backward`` and ``adam`` beside the model's own; a
  replay of the captured step opens ``step.replay`` under a profiler
  only.

Models: the 2-layer GCN and the 5-layer GIN, on a transposed or a
row-major hybrid layout or on the ELL, dense and COO tensors (row-major,
no padding rows); the 2-layer GAT on its attention layout (row-major, no
padding rows, ``ops/gat.py``).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.models.gat import GAT
from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN
from gnnadvisor_osdi21_tpu_torch.models.gin import GIN
from gnnadvisor_osdi21_tpu_torch.ops import spmm_cuda
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import (
    exact_f32_matmul, is_transposed,
)
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import GraphTensors
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import HybridTensors
from gnnadvisor_osdi21_tpu_torch.utils import profiling
from gnnadvisor_osdi21_tpu_torch.utils.checkpoint import (
    load_checkpoint, opt_state_from_torch, opt_state_to_torch,
    save_checkpoint,
)


MODELS = {"gcn": GCN, "gin": GIN, "gat": GAT}


def nll_per_row(
    log_probs: torch.Tensor, labels: torch.Tensor, transposed: bool = True
) -> torch.Tensor:
    """Each row's negative log-likelihood of its label; log_probs is
    ``[classes, N]`` when ``transposed``, else ``[N, classes]``."""
    labels = labels.to(torch.int64)
    if transposed:
        return -log_probs.gather(0, labels[None, :])[0]
    return -log_probs.gather(1, labels[:, None])[:, 0]


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
    nll = nll_per_row(log_probs, labels, transposed)
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


def build_model(
    model: str,
    generator: torch.Generator,
    in_dim: int,
    hidden: int,
    num_classes: int,
    device=None,
    model_kwargs: Mapping | None = None,
) -> torch.nn.Module:
    """The 2-layer GCN ("gcn"), the 5-layer GIN ("gin") or the 2-layer GAT
    ("gat"), its weights drawn from ``generator`` (a CPU
    ``torch.Generator``, the JAX key's counterpart) and placed on
    ``device`` (None: the card); ``model_kwargs``: the model's own
    constructor arguments (GAT's ``heads``, ``out_heads``)."""
    if model not in MODELS:
        raise ValueError(f"unknown model: {model}")
    return MODELS[model](in_dim, hidden, num_classes, generator=generator,
                         device=device, **(model_kwargs or {}))


def make_optimizer(net: torch.nn.Module, lr: float = 0.01) -> torch.optim.Adam:
    """optax.adam(lr)'s counterpart over ``net``'s parameters.  With the
    parameters on the card it is capturable: its step count stays on the
    device and its bias correction runs there in f32, as optax's does, so
    that a step can be captured and a step-by-step loop computes the same
    update.  On the CPU, where capturable Adam does not run, the host
    computes the bias correction (in f64)."""
    with profiling.span("optimizer.init"):
        on_card = next(net.parameters()).is_cuda
        return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                                eps=1e-8, capturable=on_card)


def make_train_step(
    net: torch.nn.Module,
    hts: Sequence[HybridTensors] | Sequence[GraphTensors],
    optimizer: torch.optim.Optimizer,
    mask: torch.Tensor | None = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``step(x, y) -> loss``: one training step (forward, backward, the
    optimizer's update) of ``net`` on ``hts``; the loss comes back
    detached, on the device, with no wait for it."""
    transposed = is_transposed(hts[0])

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        log_probs = net(x, hts)
        with profiling.span("loss"):
            loss = nll_loss(log_probs, y, mask, transposed)
        with profiling.span("backward"):
            loss.backward()
        with profiling.span("adam"):
            optimizer.step()
        return loss.detach()

    return step


class CapturedStep:
    """One training step captured in a ``torch.cuda.CUDAGraph``.

    ``replay()`` runs the step once more on the same tensors: the weights,
    the optimizer's state and the loss history are updated in place, on
    the card.  The graph also writes each replay's loss into ``history``
    (slot ``replays``), so that no copy runs outside it.  ``launches`` is
    what the hybrid kernels' wrappers counted while the step was captured:
    the kernels each replay runs (a replay passes no wrapper, so
    ``spmm_cuda.launches`` does not move).  ``keep``: tensors the graph
    reads or writes that nothing else holds (its history slot): a graph
    does not keep its tensors alive, and the allocator would hand a freed
    one's memory to the next tensor made."""

    def __init__(self, graph: torch.cuda.CUDAGraph, history: torch.Tensor,
                 launches: dict, keep: tuple = ()):
        self.graph = graph
        self.history = history
        self.launches = launches
        self.keep = keep
        self.replays = 0

    def replay(self) -> None:
        if self.replays >= self.history.numel():
            raise RuntimeError(
                f"the captured step's loss history holds "
                f"{self.history.numel()} replays")
        if profiling.profiler_active():
            with profiling.span("step.replay"):
                self.graph.replay()
        else:
            self.graph.replay()
        self.replays += 1

    def losses(self) -> list[float]:
        return self.history[: self.replays].tolist()


def capture_step(
    step: Callable[[], torch.Tensor],
    device: torch.device,
    capacity: int = 1,
    capture_error_mode: str = "global",
) -> CapturedStep:
    """Capture ``step()`` (one training step that returns its loss, on the
    card) as a ``torch.cuda.CUDAGraph``: the graph runs the step and writes
    its loss into the history.  The step must be warmed up first
    (``warm_up``): its optimizer state, cuBLAS and the kernels' launch
    attributes exist before capture.  A step that cannot be captured (a
    host synchronisation inside it) raises; nothing falls back to running
    it eagerly.  ``capacity``: the replays whose losses the history keeps;
    ``capture_error_mode``: ``torch.cuda.graph``'s.  Span: ``capture``;
    the step's own spans record host times and no event."""
    with profiling.span("capture"):
        history = torch.zeros(capacity, dtype=torch.float32, device=device)
        slot = torch.zeros(1, dtype=torch.int64, device=device)
        graph = torch.cuda.CUDAGraph()
        before = dict(spmm_cuda.launches)
        with torch.cuda.graph(graph, capture_error_mode=capture_error_mode):
            loss = step()
            history.index_copy_(0, slot, loss.view(1))
            slot.add_(1)
        launches = {k: spmm_cuda.launches[k] - before[k] for k in before}
    return CapturedStep(graph, history, launches, keep=(slot,))


TIMED_STEP = "warm_up.timed_step"
# the card's hold before the timed step: HOLD_FACTOR times the host seconds
# of the step before it, plus HOLD_MIN_S, at most HOLD_MAX_S
HOLD_FACTOR, HOLD_MIN_S, HOLD_MAX_S = 4.0, 0.005, 0.5


def warm_up(step: Callable[[], torch.Tensor], n: int,
            device: torch.device) -> list[torch.Tensor]:
    """Run ``step()`` ``n`` times before a capture, on a side stream as
    CUDA-graph capture asks (eagerly, where ``device`` is the CPU); returns
    the losses.  Span: ``warm_up``.

    The last of two or more steps is the timed step, span ``TIMED_STEP``:
    on the card it runs inside ``profiling.device_timed``, behind a hold
    on the card sized from the host seconds of the step before it, so
    that every span inside it gets the card's seconds, back to back as
    in a replay; on the CPU its spans take the host clock alone."""
    with profiling.span("warm_up"):
        on_card = device.type == "cuda"
        side = torch.cuda.Stream(device) if on_card else None
        if on_card:
            side.wait_stream(torch.cuda.current_stream(device))
        losses, last_s = [], 0.0
        with torch.cuda.stream(side):  # None: no stream to enter
            for i in range(n):
                if i == n - 1 and n >= 2:
                    hold = min(HOLD_FACTOR * last_s + HOLD_MIN_S, HOLD_MAX_S)
                    losses.append(profiling.device_timed(
                        step, TIMED_STEP, hold, on_card))
                else:
                    t = time.perf_counter()
                    losses.append(step())
                    last_s = time.perf_counter() - t
        if on_card:
            torch.cuda.current_stream(device).wait_stream(side)
        return losses


def make_captured_step(
    net: torch.nn.Module,
    hts: Sequence[HybridTensors] | Sequence[GraphTensors],
    optimizer: torch.optim.Optimizer,
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor | None = None,
    capacity: int = 1,
) -> CapturedStep:
    """Capture one training step of ``net`` on the card; the analog of the
    JAX package's ``make_epoch_scan`` (train.py:111-155 there), whose whole
    epoch loop is one compiled program.  The optimizer must be capturable
    (``make_optimizer`` on the card) and the step warmed up first
    (``warm_up``)."""
    if not x.is_cuda:
        raise ValueError("only a step on the card can be captured")
    step = make_train_step(net, hts, optimizer, mask)
    return capture_step(lambda: step(x, y), x.device, capacity)


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
    use_scan: bool = True,
    save_ckpt: str | None = None,
    resume: str | None = None,
    model_kwargs: Mapping | None = None,
) -> dict:
    """Train ``model`` ("gcn", "gin" or "gat", with ``model_kwargs``)
    full-graph and time its epochs with the reference protocol.

    ``dry_run`` warm-up epochs run first, step by step.  On the card, the
    timed epochs then run in windows, one window being ``chunk`` epochs
    between two CUDA events: ``chunk = max(1, num_epochs // 8)``, so that
    at least 8 windows cover ``num_epochs`` (the reference sizes its chunk
    from a TPU execution limit that does not exist here).  ``n_exec =
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

    ``use_scan`` (on the card): after the dry run (at least one step), one
    step is captured as a CUDA graph (``make_captured_step``) and every
    timed epoch replays it; a capture that fails raises.
    ``use_scan=False``: the timed epochs run step by step, as the
    reference's loop.  Both run the same kernels and the same capturable
    Adam (``make_optimizer``), so they train to the same weights.  On the
    CPU (``device="cpu"``) there is nothing to capture and nothing is
    timed: the ``dry_run + num_epochs`` steps run one by one, whatever
    ``use_scan`` says, and ``epoch_ms`` is None.

    ``x`` [R, D] row-major features and ``y`` [R] labels in the tensors'
    row space (``InputProperty.pad_features``: the hybrid layout's padded
    rows, the graph's N rows otherwise); ``mask`` [R] (1 on real rows;
    None for the ELL, dense and COO tensors, which have no padding).
    ``init_params`` carries JAX weights across (``params_from_jax``);
    otherwise the weights come from a ``torch.Generator`` seeded with
    ``seed``.  ``resume`` restores (weights, Adam state, step) from a
    checkpoint of either package first; ``save_ckpt`` writes them at the
    end.

    Returns the reference's keys (``epoch_ms``, ``dispatch_ms`` = 0.0,
    ``exec_fixed_ms``, ``warmup_s``, ``final_loss``, ``num_epochs``,
    ``step`` = the resumed step plus every step run here, ``params`` =
    the weights by JAX name as numpy arrays, ``opt_state`` = the optax
    Adam state ``{"count", "mu", "nu"}``) and ``losses`` (every step's
    here), ``dry_run``, ``model`` (the module), ``chunk``, ``chunk2``,
    ``window_ms`` / ``window2_ms`` (each window's ms, empty off the card),
    ``replays`` (steps run by replaying the captured step) and
    ``graph_launches`` (the hybrid kernels in the captured step, None
    without one)."""
    if model not in MODELS:
        raise ValueError(f"unknown model: {model}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        exact_f32_matmul()
    net = build_model(model, torch.Generator().manual_seed(seed), x.shape[1],
                      hidden, num_classes, device=dev,
                      model_kwargs=model_kwargs)
    if init_params is not None:
        net.params_from_jax(init_params)
    capture = on_card and use_scan and num_epochs > 0
    opt = make_optimizer(net, lr)
    start_step = 0
    if resume:
        params, opt_state, start_step = load_checkpoint(
            resume, net.params_to_jax(), opt_state_from_torch(net, opt))
        net.params_from_jax(params)
        opt_state_to_torch(net, opt, opt_state)
    transposed = is_transposed(hts[0])
    x = torch.as_tensor(x, dtype=torch.float32)
    if transposed:
        x = x.t()  # the transposed layout wants [D, R]: once, at setup
    x = x.contiguous().to(dev)
    labels = torch.as_tensor(y).to(dev, torch.int64)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.float32).to(dev)
    train_step = make_train_step(net, hts, opt, mask)
    losses: list[torch.Tensor] = []

    def step() -> None:
        losses.append(train_step(x, labels))

    if capture:
        # the captured step needs a warmed-up one before it (as the JAX
        # package's scan runs its warm program at least once)
        dry_run = max(dry_run, 1)
    t0 = time.perf_counter()
    if capture:
        losses += warm_up(lambda: train_step(x, labels), dry_run, dev)
    else:
        for _ in range(dry_run):
            step()
    if on_card:
        torch.cuda.synchronize(dev)
    warmup_s = time.perf_counter() - t0

    epoch_ms, exec_fixed_ms = None, 0.0
    chunk = chunk2 = 0
    window_ms: list[float] = []
    window2_ms: list[float] = []
    captured = None
    if on_card and num_epochs:
        chunk, n_exec, chunk2, n2 = timing_plan(num_epochs)
        run = step
        if capture:
            captured = make_captured_step(
                net, hts, opt, x, labels, mask,
                capacity=n_exec * chunk + n2 * chunk2)
            run = captured.replay
        window_ms = [_window_ms(run, chunk) for _ in range(n_exec)]
        window2_ms = [_window_ms(run, chunk2) for _ in range(n2)]
        epoch_ms, exec_fixed_ms = marginal_fit(
            window_ms, window2_ms, chunk, chunk2
        )
        num_epochs = n_exec * chunk
    else:
        for _ in range(num_epochs):
            step()
    loss_values = torch.stack(losses).tolist() if losses else []
    if captured is not None:
        loss_values += captured.losses()
    final_step = start_step + len(loss_values)
    params = net.params_to_jax()
    opt_state = opt_state_from_torch(net, opt)
    if save_ckpt:
        save_checkpoint(save_ckpt, params, opt_state, step=final_step)
    return {
        "epoch_ms": epoch_ms,
        "dispatch_ms": 0.0,
        "exec_fixed_ms": exec_fixed_ms,
        "warmup_s": warmup_s,
        "final_loss": loss_values[-1] if loss_values else None,
        "num_epochs": num_epochs,
        "step": final_step,
        "params": params,
        "opt_state": opt_state,
        "losses": loss_values,
        "dry_run": dry_run,
        "model": net,
        "chunk": chunk,
        "chunk2": chunk2,
        "window_ms": window_ms,
        "window2_ms": window2_ms,
        "replays": 0 if captured is None else captured.replays,
        "graph_launches": None if captured is None else captured.launches,
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
