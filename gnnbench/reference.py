"""The plain reference: a configuration's training steps in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
builds its own CSR from the traffic's edge list, and the harness hands it
the same seeded features, labels and weights it handed the program.  The
model's layers are its module's (``models/<model>.py``, ``spec.Model``),
which the caller hands in; this file holds what every model shares, the
semantics the configurations state (the port's and GNNAdvisor OSDI'21's):

- the aggregation ``Agg(h)[s] = sum over the edges (s, d) of w_sd h[d]``
  over the edge list with duplicates merged, ``w_sd`` 1 or, with
  ``norm``, ``deg[s] deg[d]`` with ``deg = sqrt(max(out-degree, 1))``;
- the aggregation's backward is the same aggregation applied to the
  incoming gradient (GNNAdvisor's ``gnn_conv.py:23-27``): autograd's
  adjoint on a symmetric graph, and on a directed one the definition
  the system trains with;
- the mean negative log-likelihood of the model's log-probabilities
  over every node;
- Adam with bias correction (``p -= lr / (1 - b1^t) * m / (sqrt(v) /
  sqrt(1 - b2^t) + eps)``).

It computes in the precision the configuration states: float32 with TF32
off, every aggregation operand (with ``norm`` scaled by the source's
degree factor, as the configurations' semantics put it) rounded to the
stated operand dtype (bfloat16) and accumulated in float32.  Each
aggregation runs in blocks of edges, so that it fits beside nothing
else.  A model reaches the aggregation and the GEMMs through
``Kernels``, which carries that precision.

``CONTROLS`` are the same steps one precision below each that the
configurations state, for the control that must come out not correct:
``int8`` rounds every aggregation operand to int8 (one scale per
tensor), ``tf32`` rounds every GEMM operand, forward and backward, to
TF32.
"""

from __future__ import annotations

import numpy as np
import torch

# elements of one gathered block of edge rows (512 MiB of float32)
_BLOCK_ELEMS = 1 << 27


def build_csr(src: np.ndarray, dst: np.ndarray, n: int):
    """(indptr [n+1], indices [nnz]), int64, rows = sources, duplicate
    (src, dst) pairs merged and each row's columns in ascending order."""
    keys = np.unique(np.asarray(src, np.int64) * n + np.asarray(dst, np.int64))
    rows, cols = keys // n, keys % n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols


class Graph:
    """The CSR as tensors on a device: ``indptr`` (each row's first edge,
    [n+1]), and per edge ``rows`` (the edge's source, whose output row it
    adds to) and ``cols`` (the row it reads), rows ascending; and the
    per-node ``deg`` factors."""

    def __init__(self, src, dst, n: int, device):
        indptr, cols = build_csr(src, dst, n)
        counts = np.diff(indptr)
        self.n = n
        self.nnz = int(cols.shape[0])
        self.indptr = torch.from_numpy(indptr).to(device)
        self.rows = torch.from_numpy(
            np.repeat(np.arange(n, dtype=np.int64), counts)).to(device)
        self.cols = torch.from_numpy(cols).to(device)
        self.deg = torch.from_numpy(
            np.sqrt(np.maximum(counts, 1).astype(np.float64))
            .astype(np.float32)).to(device)


def _int8(h: torch.Tensor) -> torch.Tensor:
    """h rounded to int8 under one symmetric scale for the whole tensor
    (its largest magnitude maps to 127), back in float32."""
    amax = h.abs().amax()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(h / scale).clamp(-127, 127) * scale


def _bf16(h: torch.Tensor) -> torch.Tensor:
    """h rounded to bfloat16 (to nearest even), back in float32."""
    return h.to(torch.bfloat16).to(torch.float32)


OPERANDS = {"float32": None, "bfloat16": _bf16, "int8": _int8}
# the controls: ``follow``'s keyword arguments for each
CONTROLS = {"int8": {"operand": "int8"}, "tf32": {"tf32": True}}


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """a rounded to TF32 (10 mantissa bits, to nearest), in float32."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def aggregate(h: torch.Tensor, g: Graph, norm: bool,
              operand: str = "float32"):
    """out[s] = sum over the edges (s, d) of w_sd h[d], accumulated in
    float32; the operand, h scaled by deg (GCN), is first rounded to
    ``operand`` (``OPERANDS``)."""
    src = h * g.deg[:, None] if norm else h
    if OPERANDS[operand] is not None:
        src = OPERANDS[operand](src)
    out = torch.zeros((g.n, h.shape[1]), dtype=torch.float32, device=h.device)
    block = max(1, _BLOCK_ELEMS // max(h.shape[1], 1))
    for s in range(0, g.nnz, block):
        rows, cols = g.rows[s:s + block], g.cols[s:s + block]
        out.index_add_(0, rows, src.index_select(0, cols))
    if norm:
        out = out * g.deg[:, None]
    return out


class _Agg(torch.autograd.Function):
    """The aggregation, whose backward is the same aggregation."""

    @staticmethod
    def forward(ctx, h, g, norm, operand):
        ctx.g, ctx.norm, ctx.operand = g, norm, operand
        return aggregate(h, g, norm, operand)

    @staticmethod
    def backward(ctx, grad):
        return (aggregate(grad, ctx.g, ctx.norm, ctx.operand), None, None,
                None)


def _gemm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        return _Tf32Gemm.apply(a, b)
    return a @ b


class _Tf32Gemm(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, in the backward too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        return g @ _tf32(b).t(), _tf32(a).t() @ g


class Kernels:
    """The aggregation and the GEMM a model's forward reaches, with one
    run's precision: ``agg`` rounds its operand to ``operand``
    (``OPERANDS``); ``gemm``, with ``tf32``, rounds both operands to TF32,
    forward and backward.  So ``CONTROLS`` reach every model."""

    def __init__(self, operand: str = "float32", tf32: bool = False):
        self.operand, self.tf32 = operand, tf32

    def agg(self, h: torch.Tensor, g: Graph,
            norm: bool = False) -> torch.Tensor:
        return _Agg.apply(h, g, norm, self.operand)

    def gemm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _gemm(a, b, self.tf32)


def forward(model, params: list[torch.Tensor], x: torch.Tensor, g: Graph,
            operand: str = "float32", tf32: bool = False) -> torch.Tensor:
    """Log-probabilities [n, classes] of ``model`` (``spec.Model``: the
    configuration and its module), its aggregation operands rounded to
    ``operand`` and, with ``tf32``, its GEMM operands to TF32."""
    return model.arch.forward(model.config, params, x, g,
                              Kernels(operand, tf32))


def follow(model, g: Graph, x: torch.Tensor, labels: torch.Tensor,
           params0: list[torch.Tensor], steps: int = 3,
           operand: str | None = None, tf32: bool = False,
           loss_rows=None) -> dict:
    """Train ``model`` (``spec.Model``) ``steps`` steps from ``params0``;
    returns each step's loss (``losses``), each leaf's first gradient
    (``grad1``) and each leaf's change after the last step (``delta``),
    as float32 tensors, and the share of the first loss that its largest
    thousandth of the nodes carry (``top_share``).
    ``operand``: the aggregation operands' precision (``OPERANDS``);
    None is the configuration's own.  ``tf32``: GEMM operands rounded to
    TF32.  ``loss_rows``: the nodes the loss averages over (None: all)."""
    cfg = model.config
    operand = operand or cfg["precision"]["agg_operands"]
    if operand not in OPERANDS:
        raise ValueError(f"unknown precision {operand!r}")
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        opt = cfg["optimizer"]
        lr, b1, b2, eps = opt["lr"], opt["b1"], opt["b2"], opt["eps"]
        params = [p.detach().clone().requires_grad_(True) for p in params0]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        losses, grad1, top = [], None, None
        for t in range(1, steps + 1):
            logp = forward(model, params, x, g, operand, tf32)
            nll = -logp.gather(1, labels[:, None])[:, 0]
            loss = (nll if loss_rows is None else nll[loss_rows]).mean()
            grads = torch.autograd.grad(loss, params)
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = [gr.detach().clone() for gr in grads]
                k = max(1, nll.numel() // 1000)
                top = float(nll.detach().topk(k).values.sum()
                            / nll.detach().sum())
            with torch.no_grad():
                for p, gr, mi, vi in zip(params, grads, m, v):
                    mi.mul_(b1).add_(gr, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                    denom = vi.sqrt() / (1 - b2 ** t) ** 0.5 + eps
                    p.addcdiv_(mi, denom, value=-lr / (1 - b1 ** t))
            del logp, loss, grads
        delta = [(p.detach() - p0).clone() for p, p0 in zip(params, params0)]
        return {"losses": losses, "grad1": grad1, "delta": delta,
                "top_share": top}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
