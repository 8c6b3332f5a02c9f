"""5-layer GIN, the reference's inline ``Net`` (GNNA_main.py:154-171).

The port of ``gnnadvisor_osdi21_tpu/models/gin.py``: single-weight GIN
layers (GINConv, gnn_conv.py:128-147) with ε = 0.5, no MLP, no bias and no
self term, so a layer is ``(ε · Σ_neighbours x) @ W``; ReLU between the
layers and ``log_softmax`` over the class axis of the output, ``[R,
classes]`` or, on a transposed layout, ``[classes, R]``.  The widths are
``[in] + [hidden] * 4 + [classes]``, with the GCN's uniform
``±1/sqrt(out_dim)`` init, layer by layer from one generator.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.models.gcn import (
    _uniform_weight, jax_params, load_jax_params,
)
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import gin_conv, is_transposed
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import GraphTensors
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import HybridTensors

NUM_LAYERS = 5
LAYER_NAMES = tuple(f"conv{i + 1}" for i in range(NUM_LAYERS))


class GIN(nn.Module):
    """Weights ``conv1 [in, hidden]``, ``conv2..conv4 [hidden, hidden]`` and
    ``conv5 [hidden, classes]``, drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) and placed on ``device`` (None:
    the card)."""

    def __init__(
        self,
        in_dim: int,
        hidden: int,
        num_classes: int,
        generator: torch.Generator | None = None,
        device=None,
        epsilon: float = 0.5,
    ):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.epsilon = epsilon
        dims = [in_dim] + [hidden] * (NUM_LAYERS - 1) + [num_classes]
        for i, name in enumerate(LAYER_NAMES):
            w = _uniform_weight(dims[i], dims[i + 1], generator)
            setattr(self, name, nn.Parameter(w.to(dev)))

    def forward(
        self, x: torch.Tensor,
        hts: Sequence[HybridTensors] | Sequence[GraphTensors],
    ) -> torch.Tensor:
        """x [R, in] -> log-probabilities [R, classes] (transposed layouts:
        [in, R] -> [classes, R]).  ``hts`` = the (input-layer, hidden-layer)
        tensor sets, hybrid layouts or ELL/dense/COO ``GraphTensors``:
        layer 1 aggregates on the first, layers 2-5 on the last."""
        h = x
        for i, name in enumerate(LAYER_NAMES):
            ht = hts[0] if i == 0 else hts[-1]
            h = gin_conv(h, getattr(self, name), ht, self.epsilon)
            if i < NUM_LAYERS - 1:
                h = torch.relu(h)
        return torch.log_softmax(h, dim=0 if is_transposed(hts[0]) else 1)

    def params_from_jax(self, params: Mapping[str, np.ndarray]) -> "GIN":
        """Carry weights across from the JAX model's ``{"conv1".."conv5"}``
        (as numpy arrays)."""
        load_jax_params(self, params, LAYER_NAMES)
        return self

    def params_to_jax(self) -> dict[str, np.ndarray]:
        """The weights as the JAX model's ``{"conv1".."conv5"}`` (numpy)."""
        return jax_params(self)
