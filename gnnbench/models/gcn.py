"""GCN as GNNAdvisor OSDI'21 trains it (Kipf & Welling, arXiv:1609.02907).

Layer ``Agg(h W)``, with ``Agg(h)[s] = sum over the edges (s, d) of
deg[s] deg[d] h[d]`` and ``deg = sqrt(max(out-degree, 1))`` (multiplied,
not divided: GNNAdvisor's ``dataset.py:121-122``); no bias, no self loop,
ReLU between layers, ``log_softmax`` over the classes.  Weights
``conv1..convL`` ``[a, b]``, uniform in +-1/sqrt(b).  The port's model
of the same name trains it.
"""

from __future__ import annotations

import torch

PORT = "gcn"
KEYS = ()


def widths(config: dict, traffic: dict) -> list[int]:
    """``[F, H, ..., H, C]``: the features, ``num_layers - 1`` hidden
    widths and the classes."""
    layers = int(config["num_layers"])
    return ([int(traffic["features"])] + [int(config["hidden"])] * (layers - 1)
            + [int(traffic["classes"])])


def weights(config: dict, traffic: dict) -> list[tuple]:
    ws = widths(config, traffic)
    return [(f"conv{i + 1}", (a, b), 1.0 / float(b) ** 0.5)
            for i, (a, b) in enumerate(zip(ws[:-1], ws[1:]))]


def port_kwargs(config: dict) -> dict:
    return {}


def forward(config: dict, params: list[torch.Tensor], x: torch.Tensor, g,
            k) -> torch.Tensor:
    h = x
    last = len(params) - 1
    for i, w in enumerate(params):
        h = k.agg(k.gemm(h, w), g, norm=True)
        if i < last:
            h = torch.relu(h)
    return torch.log_softmax(h, dim=1)


def step_ops(config: dict, rf, n: int, e: int, widths: list[int],
             operand: int) -> list:
    """Layer i forward: the GEMM, then the aggregation at the layer's
    output width.  Backward, last layer first: the aggregation, the
    weight's gradient and, past the first layer, the input's gradient
    (the input features need none)."""
    ops = []
    layers = list(zip(widths[:-1], widths[1:]))
    for a, b in layers:
        ops += [rf.gemm(n, a, b), rf.agg(n, e, b, True, operand)]
    for i, (a, b) in reversed(list(enumerate(layers))):
        ops.append(rf.agg(n, e, b, True, operand))
        ops.append(rf.gemm(a, n, b))  # dW = h^T @ dZ
        if i > 0:
            ops.append(rf.gemm(n, b, a))  # dh = dZ @ W^T
    return ops
