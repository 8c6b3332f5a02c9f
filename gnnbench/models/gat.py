"""GAT (Veličković et al., "Graph Attention Networks", ICLR 2018,
arXiv:1710.10903, §3.3, the transductive setup for Pubmed), in plain
torch.

Per layer and head h, over the edges (s, d) of each row s of the graph
with one self-loop a node added (a self-loop already in the edge list
kept once): ``v = h W``; ``e_sd = LeakyReLU(a_src,h . v_s + a_dst,h .
v_d)`` with the configuration's ``negative_slope``; ``alpha_sd`` = the
softmax of ``e_sd`` over row s; ``out_s = sum of alpha_sd v_d``.  Layer 1
concatenates its ``heads`` heads of ``hidden`` features and applies ELU;
layer 2 averages its ``out_heads`` heads of one feature a class, then
``log_softmax``.  No bias (the paper's equations; the authors' code adds
one), no dropout.  Weights ``conv<i>`` [in, K*F] (head h at columns
h*F..), ``att_src<i>`` and ``att_dst<i>`` [K, F], uniform in the Glorot
bounds of the authors' code, per head: sqrt(6 / (in + F)) for the
projection and sqrt(6 / (F + 1)) for an attention vector.  The port's
model of the same name trains it.

Precision: scores, alpha, the softmax's statistics and every sum in
float32; the projections through ``k.gemm`` (so the TF32 control reaches
them); the gathered operands rounded to ``k.operand`` (so the int8
control reaches them), as the configuration states: v where the
aggregation gathers it (its gradient passes the rounding unchanged), and
the output's gradient where the adjoint aggregation gathers it.  The
backward is autograd's, the true adjoint: the softmax's backward, and
every gather's backward a sum over the edges that gathered each row.
Every sum runs over sorted segments (``torch.segment_reduce``, each
segment in edge order), so that the numbers repeat from run to run on
the card too (``index_add_``'s atomics do not); the aggregation runs
over blocks of rows, each gathering at most ``BLOCK_ELEMS`` values.

Both scores of every head are one product with a block-diagonal matrix,
and the softmax and the aggregation sum in edge order, each product
rounded: the plain float32 forward, whose bits a program that sums the
same way reproduces.  That matters at a bfloat16 operand: values a
float32 rounding apart round a whole bf16 step apart now and then, and
layer 2 gathers the hub's row a quarter of a million times.
"""

from __future__ import annotations

import numpy as np
import torch

PORT = "gat"
KEYS = ("heads", "out_heads", "negative_slope", "self_loops", "activation")
BLOCK_ELEMS = 1 << 28  # gathered values of one block of rows (1 GiB)


def widths(config: dict, traffic: dict) -> list[int]:
    """``[F, heads * hidden, C]``: the features, layer 1's concatenated
    heads and the classes."""
    return [int(traffic["features"]),
            int(config["heads"]) * int(config["hidden"]),
            int(traffic["classes"])]


def _layers(config: dict, traffic: dict) -> list[tuple[int, int, int]]:
    """(input width, heads, features a head) of each layer."""
    f_in, h1, c = widths(config, traffic)
    return [(f_in, int(config["heads"]), int(config["hidden"])),
            (h1, int(config["out_heads"]), c)]


def weights(config: dict, traffic: dict) -> list[tuple]:
    out = []
    for i, (a, k, f) in enumerate(_layers(config, traffic), start=1):
        att = (6.0 / (f + 1)) ** 0.5
        out += [(f"conv{i}", (a, k * f), (6.0 / (a + f)) ** 0.5),
                (f"att_src{i}", (k, f), att), (f"att_dst{i}", (k, f), att)]
    return out


def port_kwargs(config: dict) -> dict:
    return {"heads": int(config["heads"]),
            "out_heads": int(config["out_heads"]),
            "negative_slope": float(config["negative_slope"])}


def _int8(h: torch.Tensor) -> torch.Tensor:
    amax = h.abs().amax()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(h / scale).clamp(-127, 127) * scale


# the harness's operand precisions (``reference.OPERANDS``), by name
_ROUND = {"float32": lambda h: h,
          "bfloat16": lambda h: h.to(torch.bfloat16).to(torch.float32),
          "int8": _int8}


def _round(operand: str):
    if operand not in _ROUND:
        raise ValueError(f"unknown precision {operand!r}")
    return _ROUND[operand]


class _Gather(torch.autograd.Function):
    """``t[index]``, whose backward sums each row's gathered gradients in
    sorted segments: ``order`` sorts the edges by ``index`` (None: they
    are), ``offsets`` [rows + 1] bounds each row's run in that order."""

    @staticmethod
    def forward(ctx, t, index, order, offsets):
        ctx.index_order, ctx.offsets = order, offsets
        return t.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        if ctx.index_order is not None:
            g = g.index_select(0, ctx.index_order)
        return (torch.segment_reduce(g, "sum", offsets=ctx.offsets, axis=0,
                                     unsafe=True), None, None, None)


class _Weigh(torch.autograd.Function):
    """``alpha[:, :, None] * rows``, the messages of the edges: the
    product's own backward, except that the rows' gradient takes the
    incoming gradient (each edge's row of the output's gradient) rounded
    to the operand precision, as the adjoint aggregation gathers it."""

    @staticmethod
    def forward(ctx, alpha, rows, rnd):
        ctx.save_for_backward(alpha, rows)
        ctx.rnd = rnd
        return alpha[:, :, None] * rows

    @staticmethod
    def backward(ctx, g):
        alpha, rows = ctx.saved_tensors
        return ((g * rows).sum(-1), alpha[:, :, None] * ctx.rnd(g), None)


class _Edges:
    """The graph's edges with one self-loop a node, rows ascending and each
    row's columns ascending: ``indptr``, ``rows``, ``cols``, and the
    order sorting them by column with its segment offsets."""

    def __init__(self, g):
        n = g.n
        keys = torch.cat([g.rows * n + g.cols,
                          torch.arange(n, device=g.cols.device) * (n + 1)])
        keys = torch.unique(keys)
        self.n, self.rows, self.cols = n, keys // n, keys % n
        self.indptr = _offsets(self.rows, n)
        self.col_order = torch.argsort(self.cols, stable=True)
        self.col_offsets = _offsets(self.cols, n)


def _offsets(index: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n + 1, dtype=torch.int64, device=index.device)
    out[1:] = torch.cumsum(torch.bincount(index, minlength=n), 0)
    return out


def _score_matrix(a_src: torch.Tensor, a_dst: torch.Tensor) -> torch.Tensor:
    """[K*F, 2K]: ``a_src[h]`` in column h and ``a_dst[h]`` in column K + h,
    each on head h's rows, zeros elsewhere: ``v @`` it gives both scores
    of every head, a float32 product (its zeros add nothing)."""
    return torch.cat([torch.block_diag(*a_src[:, None]).t(),
                      torch.block_diag(*a_dst[:, None]).t()], dim=1)


def _layer(h, w, a_src, a_dst, g: _Edges, k, slope: float, rnd):
    n = h.shape[0]
    heads, f = a_src.shape
    v = k.gemm(h, w)
    vh = v.view(n, heads, f)
    scores = v @ _score_matrix(a_src, a_dst)
    s_src, s_dst = scores[:, :heads], scores[:, heads:]
    e = torch.nn.functional.leaky_relu(
        _Gather.apply(s_src, g.rows, None, g.indptr)
        + _Gather.apply(s_dst, g.cols, g.col_order, g.col_offsets), slope)
    top = torch.segment_reduce(e.detach(), "max", offsets=g.indptr, axis=0,
                               unsafe=True)
    p = torch.exp(e - top[g.rows])
    total = torch.segment_reduce(p, "sum", offsets=g.indptr, axis=0,
                                 unsafe=True)
    alpha = p / _Gather.apply(total, g.rows, None, g.indptr)
    # the gathered operand: v rounded, its gradient passed through
    vb = (vh + (rnd(vh) - vh).detach()).reshape(n, heads * f)
    outs = []
    for r0, r1 in _blocks(g.indptr, BLOCK_ELEMS // (heads * f)):
        lo, hi = int(g.indptr[r0]), int(g.indptr[r1])
        cols = g.cols[lo:hi]
        rows = _Gather.apply(vb, cols, *_block_order(g, cols)).view(
            -1, heads, f)
        msgs = _Weigh.apply(alpha[lo:hi], rows, rnd)
        outs.append(torch.segment_reduce(
            msgs.reshape(hi - lo, heads * f), "sum",
            offsets=g.indptr[r0:r1 + 1] - lo, axis=0, unsafe=True))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _blocks(indptr: torch.Tensor, edges: int) -> list[tuple[int, int]]:
    """Consecutive row ranges of at most ``edges`` edges each (a longer
    row alone)."""
    ptr = indptr.cpu().numpy()
    n, out, r0 = len(ptr) - 1, [], 0
    while r0 < n:
        r1 = int(np.searchsorted(ptr, ptr[r0] + max(edges, 1), "right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        out.append((r0, r1))
        r0 = r1
    return out


def _block_order(g: _Edges, cols: torch.Tensor):
    """(order, offsets) sorting one block's edges by column, for its
    gather's backward."""
    if cols.numel() == g.cols.numel():
        return g.col_order, g.col_offsets
    return torch.argsort(cols, stable=True), _offsets(cols, g.n)


def forward(config: dict, params: list[torch.Tensor], x: torch.Tensor, g,
            k) -> torch.Tensor:
    if not config["self_loops"] or config["activation"] != "elu":
        raise ValueError("GAT as configured here adds self-loops and "
                         "applies ELU")
    slope = float(config["negative_slope"])
    rnd = _round(k.operand)
    edges = _Edges(g)
    w1, as1, ad1, w2, as2, ad2 = params
    h = torch.nn.functional.elu(_layer(x, w1, as1, ad1, edges, k, slope, rnd))
    out = _layer(h, w2, as2, ad2, edges, k, slope, rnd)
    heads = as2.shape[0]
    return torch.log_softmax(out.view(x.shape[0], heads, -1).mean(1), dim=1)


def step_ops(config: dict, rf, n: int, e: int, widths: list[int],
             operand: int) -> list:
    """One training step's operations, counted from n, the edges with their
    self-loops ``E = e + n`` and the widths, each reading its inputs once
    and writing its outputs once.  ``gemm``: each layer's projection, its
    weight's gradient and, in layer 2, its input's gradient.  ``agg``: the
    alpha-weighted aggregation of each layer, forward (the operand at
    ``operand`` bytes, alpha, the column ids and row pointers read, the
    float32 output written) and adjoint (the same, with the permutation
    read too).  ``attn``: each layer's scores and softmax (the node scores
    and ids read, alpha written), its SDDMM with the softmax's backward
    and the row sums of the logits' gradient (the operand, the output and
    its gradient, alpha and the scores read; the logits' gradient and its
    row sums written), and the column sums of the logits' gradient (it and
    the permutation read, the column sums written)."""
    f_in, h1, c = widths
    layers = [(f_in, int(config["heads"]), h1 // int(config["heads"])),
              (h1, int(config["out_heads"]), c)]
    edges = e + n
    f32, idx = 4, 4
    ptrs = (n + 1) * idx
    ops = []
    for a, heads, f in layers:
        w = heads * f
        agg_bytes = (n * w * (operand + f32) + edges * heads * f32
                     + edges * idx + ptrs)
        ops += [
            rf.gemm(n, a, w),
            rf.Op("attn", 5 * edges * heads,
                  2 * n * heads * f32 + edges * idx + ptrs
                  + edges * heads * f32),
            rf.Op("agg", 2 * edges * w, agg_bytes, w),
        ]
    for i, (a, heads, f) in reversed(list(enumerate(layers))):
        w = heads * f
        ops += [
            rf.Op("attn", 2 * edges * w + 4 * edges * heads,
                  n * w * (operand + 2 * f32) + edges * heads * f32
                  + 2 * n * heads * f32 + edges * idx + ptrs
                  + edges * heads * f32 + n * heads * f32),
            rf.Op("attn", edges * heads,
                  edges * heads * f32 + edges * idx + ptrs
                  + n * heads * f32),
            rf.Op("agg", 2 * edges * w,
                  n * w * (operand + f32) + edges * heads * f32
                  + 2 * edges * idx + ptrs, w),
            rf.gemm(a, n, w),
        ]
        if i > 0:
            ops.append(rf.gemm(n, w, a))
    return ops
