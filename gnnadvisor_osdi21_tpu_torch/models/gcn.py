"""2-layer GCN, the reference's inline ``Net`` (GNNA_main.py:142-153).

The port of ``gnnadvisor_osdi21_tpu/models/gcn.py``: bias-free
single-weight GCN layers with uniform ``±1/sqrt(out_dim)`` init
(GCNConv, gnn_conv.py:80-98), forward
``log_softmax(conv2(relu(conv1(x))))`` over the class axis of the output,
``[R, classes]`` or, on a transposed layout, ``[classes, R]``.  The
per-layer parameter switch (param.py:122-141) is a pair of layouts, one
per layer.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import gcn_conv, is_transposed
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import GraphTensors
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import HybridTensors
from gnnadvisor_osdi21_tpu_torch.utils import profiling


def _uniform_weight(
    in_dim: int, out_dim: int, generator: torch.Generator
) -> torch.Tensor:
    stdv = 1.0 / float(np.sqrt(out_dim))
    w = torch.rand((in_dim, out_dim), generator=generator, dtype=torch.float32)
    return w * (2 * stdv) - stdv


@torch.no_grad()
def load_jax_params(
    module: nn.Module, params: Mapping[str, np.ndarray], names: Sequence[str]
) -> None:
    """Copy the JAX model's weights (numpy arrays under ``names``) into the
    module's parameters of the same names, with shape checks."""
    for name in names:
        p = getattr(module, name)
        w = torch.tensor(np.asarray(params[name], dtype=np.float32))
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(
                f"{name}: JAX weight {tuple(w.shape)} != {tuple(p.shape)}"
            )
        p.copy_(w)


def jax_params(module: nn.Module) -> dict[str, np.ndarray]:
    """The module's weights as numpy copies under their names, the JAX
    model's parameter dict (``load_jax_params``'s inverse)."""
    return {name: p.detach().cpu().numpy().copy()
            for name, p in module.named_parameters()}


class GCN(nn.Module):
    """Weights ``conv1 [in, hidden]`` and ``conv2 [hidden, classes]``, drawn
    from ``generator`` (a CPU ``torch.Generator``; seed 0 when None) and
    placed on ``device`` (None: the card), inside the span ``model.init``.
    The forward's spans: ``forward.layer<i>.gemm``, ``.aggregate``,
    ``forward.layer0.relu`` and ``forward.log_softmax``."""

    def __init__(
        self,
        in_dim: int,
        hidden: int,
        num_classes: int,
        generator: torch.Generator | None = None,
        device=None,
    ):
        super().__init__()
        with profiling.span("model.init"):
            dev = resolve_device(device)
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.conv1 = nn.Parameter(
                _uniform_weight(in_dim, hidden, generator).to(dev)
            )
            self.conv2 = nn.Parameter(
                _uniform_weight(hidden, num_classes, generator).to(dev)
            )

    def forward(
        self, x: torch.Tensor,
        hts: Sequence[HybridTensors] | Sequence[GraphTensors],
    ) -> torch.Tensor:
        """x [R, in] -> log-probabilities [R, classes] (transposed layouts:
        [in, R] -> [classes, R]).  ``hts`` = the (input-layer, hidden-layer)
        tensor sets, hybrid layouts or ELL/dense/COO ``GraphTensors``; the
        same one twice is fine."""
        h = gcn_conv(x, self.conv1, hts[0], layer=0)
        with profiling.span("forward.layer0.relu"):
            h = torch.relu(h)
        out = gcn_conv(h, self.conv2, hts[-1], layer=1)
        with profiling.span("forward.log_softmax"):
            return torch.log_softmax(out,
                                     dim=0 if is_transposed(hts[0]) else 1)

    def params_from_jax(self, params: Mapping[str, np.ndarray]) -> "GCN":
        """Carry weights across from the JAX model's ``{"conv1", "conv2"}``
        (as numpy arrays)."""
        load_jax_params(self, params, ("conv1", "conv2"))
        return self

    def params_to_jax(self) -> dict[str, np.ndarray]:
        """The weights as the JAX model's ``{"conv1", "conv2"}`` (numpy)."""
        return jax_params(self)
