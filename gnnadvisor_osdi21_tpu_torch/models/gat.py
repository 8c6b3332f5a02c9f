"""2-layer GAT (Veličković et al., "Graph Attention Networks", ICLR 2018,
arXiv:1710.10903, §3.3, the transductive setup as the paper gives it for
Pubmed).

Layer 1: ``heads`` heads of ``hidden`` features, concatenated, then ELU;
layer 2: ``out_heads`` heads of ``num_classes`` features, averaged, then
``log_softmax`` over the classes, row-major ``[R, classes]``.  Each head
attends over its node's neighbours and the node itself
(``ops/gat.gat_conv``, LeakyReLU slope ``negative_slope`` on the logits).
No bias, as in the paper's equations; no dropout.  Weights, per layer i:
``conv<i>`` [in, K*F] (head h at columns h*F..), ``att_src<i>`` and
``att_dst<i>`` [K, F], drawn in that order from one generator, uniform in
the Glorot bounds of the authors' code (per head: sqrt(6 / (in + F)) for
the projection, sqrt(6 / (F + 1)) for the attention vectors).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.models.gcn import jax_params, load_jax_params
from gnnadvisor_osdi21_tpu_torch.ops.gat import GatTensors, gat_conv
from gnnadvisor_osdi21_tpu_torch.utils import profiling

LAYER_NAMES = ("conv1", "att_src1", "att_dst1", "conv2", "att_src2",
               "att_dst2")


def _glorot(shape: tuple, fan_in: int, fan_out: int,
            generator: torch.Generator) -> torch.Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.rand(shape, generator=generator, dtype=torch.float32)
    return w * (2 * bound) - bound


class GAT(nn.Module):
    """Weights ``conv1 [in, heads*hidden]``, ``att_src1``/``att_dst1
    [heads, hidden]``, ``conv2 [heads*hidden, out_heads*classes]``,
    ``att_src2``/``att_dst2 [out_heads, classes]``, drawn from
    ``generator`` (a CPU ``torch.Generator``; seed 0 when None) and placed
    on ``device`` (None: the card), inside the span ``model.init``; the
    counter ``attn.heads`` adds both layers' heads.  The forward's spans:
    ``forward.layer<i>.gemm`` and ``.attention``, ``forward.layer0.elu``,
    ``forward.layer1.mean`` and ``forward.log_softmax``."""

    def __init__(
        self,
        in_dim: int,
        hidden: int,
        num_classes: int,
        generator: torch.Generator | None = None,
        device=None,
        heads: int = 8,
        out_heads: int = 8,
        negative_slope: float = 0.2,
    ):
        super().__init__()
        with profiling.span("model.init"):
            dev = resolve_device(device)
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            self.heads, self.out_heads = heads, out_heads
            self.negative_slope = negative_slope
            for i, (a, k, f) in enumerate(
                    ((in_dim, heads, hidden),
                     (heads * hidden, out_heads, num_classes)), start=1):
                ws = (_glorot((a, k * f), a, f, generator),
                      _glorot((k, f), f, 1, generator),
                      _glorot((k, f), f, 1, generator))
                for name, w in zip(LAYER_NAMES[3 * i - 3:3 * i], ws):
                    setattr(self, name, nn.Parameter(w.to(dev)))
            profiling.count("attn.heads", heads + out_heads)

    def forward(self, x: torch.Tensor,
                hts: Sequence[GatTensors]) -> torch.Tensor:
        """x [R, in] -> log-probabilities [R, classes]; ``hts`` = the
        (input-layer, hidden-layer) attention layouts (one layout twice
        is fine)."""
        slope = self.negative_slope
        h = gat_conv(x, self.conv1, self.att_src1, self.att_dst1, hts[0],
                     slope, layer=0)
        with profiling.span("forward.layer0.elu"):
            h = torch.nn.functional.elu(h)
        out = gat_conv(h, self.conv2, self.att_src2, self.att_dst2, hts[-1],
                       slope, layer=1)
        with profiling.span("forward.layer1.mean"):
            out = out.view(out.shape[0], self.out_heads, -1).mean(dim=1)
        with profiling.span("forward.log_softmax"):
            return torch.log_softmax(out, dim=1)

    def params_from_jax(self, params: Mapping[str, np.ndarray]) -> "GAT":
        """Carry weights across by name (``LAYER_NAMES``, numpy arrays)."""
        load_jax_params(self, params, LAYER_NAMES)
        return self

    def params_to_jax(self) -> dict[str, np.ndarray]:
        """The weights by name (numpy)."""
        return jax_params(self)
