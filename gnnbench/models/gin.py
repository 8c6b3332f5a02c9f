"""GIN as GNNAdvisor OSDI'21 trains it (Xu et al., arXiv:1810.00826).

Layer ``(eps Agg(h)) W``, with ``Agg(h)[s] = sum over the edges (s, d)
of h[d]`` and the configuration's ``epsilon``; no MLP, no bias, no self
term, ReLU between layers, ``log_softmax`` over the classes.  Weights
``conv1..convL`` ``[a, b]``, uniform in +-1/sqrt(b).  The port's model
of the same name trains it, with ``epsilon``.
"""

from __future__ import annotations

import torch

PORT = "gin"
KEYS = ("epsilon",)


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
    return {"epsilon": config["epsilon"]}


def forward(config: dict, params: list[torch.Tensor], x: torch.Tensor, g,
            k) -> torch.Tensor:
    h = x
    last = len(params) - 1
    for i, w in enumerate(params):
        h = k.gemm(config["epsilon"] * k.agg(h, g), w)
        if i < last:
            h = torch.relu(h)
    return torch.log_softmax(h, dim=1)


def step_ops(config: dict, rf, n: int, e: int, widths: list[int],
             operand: int) -> list:
    """Layer i forward: the aggregation at the layer's input width, then
    the GEMM.  Backward, last layer first: the weight's gradient and,
    past the first layer, the input's gradient and its aggregation (the
    input features need none)."""
    ops = []
    layers = list(zip(widths[:-1], widths[1:]))
    for a, b in layers:
        ops += [rf.agg(n, e, a, False, operand), rf.gemm(n, a, b)]
    for i, (a, b) in reversed(list(enumerate(layers))):
        ops.append(rf.gemm(a, n, b))  # dW = Xagg^T @ dZ
        if i > 0:
            ops.append(rf.gemm(n, b, a))  # dXagg = dZ @ W^T
            ops.append(rf.agg(n, e, a, False, operand))
    return ops
