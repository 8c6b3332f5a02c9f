"""The input-adaptive parameter decider ("Advisor") for the hybrid path.

The port of ``gnnadvisor_osdi21_tpu/tuner/decider.py`` for
``method="hybrid"``: the tier sizes ``diag_b``/``hot_k`` come from the
cost model over the graph's degree and locality structure
(``graphs/hybrid.choose_tiers``) unless the user fixes them, and the
layout's tensors are shared by both layers.  Auto choices equal the JAX
decider's with its probe off.  The JAX decider's VMEM model
(decider.py:49-56, 200-224) sized TPU grid steps; the CUDA kernels size
their own launches, so it is gone.

Not ported yet, and refused with ``NotImplementedError``: the ELL, dense
and COO methods (ROADMAP.md item A.4), the row-major layout
``transposed=False`` (item A.2), reordering (item A.3) and GIN (item A.1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import build_hybrid, choose_tiers
from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    HybridTensors, build_hybrid_tensors, residual_gather, single_stage,
)

DENSE_MAX_NODES = 4096  # the JAX decider picks "dense" up to this size


@dataclasses.dataclass
class LayerConfig:
    """Per-layer parameters (the set_input/set_hidden analog)."""

    method: str
    feature_dim: int


class InputProperty:
    """Graph + model dims + tier parameters; ``decider()`` fills in the
    rest, ``build_tensors()`` builds the layout on a device."""

    def __init__(
        self,
        graph: GraphCSR,
        hidden_dim: int,
        method: Optional[str] = None,
        hot_k: Optional[int] = None,
        diag_b: Optional[int] = None,
        model: str = "gcn",
        enable_reorder: bool = False,
        manual_mode: bool = False,
        verbose: bool = False,
        agg_dtype: str = "bfloat16",
        transposed: Optional[bool] = None,
    ):
        if model != "gcn":
            raise NotImplementedError(
                f"model {model!r} is not ported yet (ROADMAP.md item A.1)"
            )
        if transposed is False:
            raise NotImplementedError(
                "the row-major layout (transposed=False) is not ported yet "
                "(ROADMAP.md item A.2)"
            )
        if enable_reorder:
            raise NotImplementedError(
                "reordering is not ported yet (ROADMAP.md item A.3)"
            )
        self.graph = graph
        self.input_dim = graph.num_features
        self.hidden_dim = hidden_dim
        self.method = method
        self.hot_k = hot_k
        self.diag_b = diag_b
        # user-fixed tier values (None = auto)
        self._user_hot_k = hot_k
        self._user_diag_b = diag_b
        self.manual_mode = manual_mode
        self.verbose = verbose
        self.agg_dtype = agg_dtype
        self.layer_input: Optional[LayerConfig] = None
        self.layer_hidden: Optional[LayerConfig] = None
        self.hybrid_graph = None  # set by build_tensors

    def pad_features(self, a):
        """Node-indexed array -> the layout's padded row space."""
        return self.hybrid_graph.pad_array(np.asarray(a))

    def unpad_outputs(self, a):
        return self.hybrid_graph.unpad_array(np.asarray(a))

    def _auto_method(self) -> str:
        return "dense" if self.graph.num_nodes <= DENSE_MAX_NODES else "hybrid"

    def decider(self) -> "InputProperty":
        """Pick the method and the tiers; manual mode passes user values
        through (param.py:58-70)."""
        if self.manual_mode:
            method = self.method or "ell"
        else:
            method = self.method or self._auto_method()
        if method != "hybrid":
            raise NotImplementedError(
                f"method {method!r} is not ported yet (ROADMAP.md item A.4); "
                "the port runs method='hybrid'"
            )
        g = self.graph
        src = np.repeat(
            np.arange(g.num_nodes, dtype=np.int64),
            np.diff(np.asarray(g.row_pointers, dtype=np.int64)),
        )
        self.diag_b, self.hot_k = choose_tiers(
            src, np.asarray(g.column_index, dtype=np.int64), g.num_nodes,
            hot_k=self.hot_k, diag_b=self.diag_b,
        )
        self.layer_input = LayerConfig(method, self.input_dim)
        self.layer_hidden = LayerConfig(method, self.hidden_dim)
        if self.verbose:
            mode = "MANUAL" if self.manual_mode else "AUTO"
            print(f"# {mode} input  layer: {self.layer_input}")
            print(f"# {mode} hidden layer: {self.layer_hidden}")
            print(f"# hybrid tiers: diag_b={self.diag_b} hot_k={self.hot_k}")
        return self

    def build_tensors(self, device=None) -> tuple[HybridTensors, HybridTensors]:
        """Build the layout and put it on ``device`` (None: the card), once
        per layer's residual gather: GCN aggregates at the hidden width,
        then at the class count, and each width may pick another gather
        (``hybrid_agg.single_stage``)."""
        if self.layer_input is None:
            raise RuntimeError("call decider() first")
        # the user's values, not the decider's: build_hybrid re-prices the
        # tiers at the residual geometry it builds, as the JAX build does
        hg = self.hybrid_graph = build_hybrid(
            self.graph, hot_k=self._user_hot_k, diag_b=self._user_diag_b
        )
        self.diag_b, self.hot_k = hg.diag_b, hg.hot_k
        agg_dims = (self.hidden_dim, self.graph.num_classes)

        ht_in = build_hybrid_tensors(
            hg, device=device, agg_dtype=self.agg_dtype,
            agg_feature_dim=agg_dims[0],
        )
        if single_stage(hg, agg_dims[0]) == single_stage(hg, agg_dims[1]):
            return ht_in, ht_in
        # the layers straddle the width limit: only the gather differs
        return ht_in, dataclasses.replace(
            ht_in, **residual_gather(hg, device, agg_dims[1])
        )
