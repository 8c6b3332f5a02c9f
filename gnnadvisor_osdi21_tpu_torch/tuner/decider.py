"""The input-adaptive parameter decider ("Advisor").

The port of ``gnnadvisor_osdi21_tpu/tuner/decider.py``.  Like the
reference's ``inputProperty.decider()`` (param.py:51-120) it derives the
run's parameters from cheap graph statistics:

- the aggregation path: ``dense`` up to ``DENSE_MAX_NODES`` nodes, else
  ``hybrid`` (the ``ell`` and ``coo`` paths run when asked for);
- ``part_size``, the neighbor-group width of the ELL path, from the ELL
  cost law (``_auto_part_size``) in place of the reference's
  ``int(avg_degree)`` (param.py:73);
- the hybrid layout's tier sizes ``diag_b``/``hot_k`` from the cost model
  over the graph's degree and locality structure
  (``graphs/hybrid.choose_tiers``) unless the user fixes them;
- reordering iff ``sqrt(avg_edgeSpan) > sqrt(N)/100`` (param.py:110)
  when ``enable_reorder``; the reorder runs inside ``decider()``, before
  the tiers are chosen, and replaces ``self.graph``, so build features
  and labels from ``prop.graph`` after it.

Manual mode passes user parameters straight through (method ``ell`` and
``part_size`` 32 by default) and reorders whenever ``enable_reorder``.
``DENSE_MAX_NODES`` and the ELL cost law are the JAX package's fits to a
TPU v5e, copied so that the port's choices equal the JAX decider's.  The
JAX decider's TPU geometry (``feature_tile``, ``block_parts``,
``vmem_budget``) is gone: the CUDA kernels size their own launches.

Models are the 2-layer GCN and the 5-layer GIN.  The hybrid layout is
transposed (``transposed=None`` or True, the JAX default for the hybrid
method) or row-major (``transposed=False``); the other paths are
row-major.  ``probe`` is the measured-probe tier autotune
(``graphs/hybrid.build_hybrid``): None probes auto tiers when the layout
is built for the card, as the JAX decider does on its TPU; False trusts
the cost model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.graphs import reorder
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import build_hybrid, choose_tiers
from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR
from gnnadvisor_osdi21_tpu_torch.graphs.partition import build_neighbor_groups
from gnnadvisor_osdi21_tpu_torch.ops import graph_tensors
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import (
    GraphTensors, build_graph_tensors,
)
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    HybridTensors, build_layer_tensors,
)

METHODS = graph_tensors.METHODS + ("hybrid",)
DENSE_MAX_NODES = 4096  # above this, an N×N adjacency stops being a win
# ELL cost law (per epoch), the JAX package's weighted least-squares fit
# over its partSize study (5 graphs x partSize 2..512 on a TPU v5e): a
# slot is one gathered (possibly padded) neighbor row, a part one
# neighbor group (the two-level reduction's per-part overhead).
ELL_SLOT_NS = 44.0
ELL_PART_NS = 125.0


@dataclasses.dataclass
class LayerConfig:
    """Per-layer parameters (the set_input/set_hidden analog)."""

    method: str
    part_size: int
    feature_dim: int


class InputProperty:
    """Graph + model dims + performance parameters; ``decider()`` fills in
    the rest, ``build_tensors()`` builds the tensors on a device."""

    def __init__(
        self,
        graph: GraphCSR,
        hidden_dim: int,
        part_size: Optional[int] = None,
        method: Optional[str] = None,
        hot_k: Optional[int] = None,
        diag_b: Optional[int] = None,
        model: str = "gcn",
        enable_reorder: bool = False,
        manual_mode: bool = False,
        verbose: bool = False,
        agg_dtype: str = "bfloat16",
        transposed: Optional[bool] = None,
        probe: Optional[bool] = None,
        gemm_dtype: str = "float32",
    ):
        if model not in ("gcn", "gin"):
            raise ValueError(f"unknown model: {model}")
        self.graph = graph
        self.input_dim = graph.num_features
        self.hidden_dim = hidden_dim
        self.part_size = part_size
        self.method = method
        self.hot_k = hot_k
        self.diag_b = diag_b
        # user-fixed tier values (None = auto)
        self._user_hot_k = hot_k
        self._user_diag_b = diag_b
        self.model = model
        self.enable_reorder = enable_reorder
        self.manual_mode = manual_mode
        self.verbose = verbose
        self.agg_dtype = agg_dtype
        self.transposed = transposed
        self.probe = probe
        self.gemm_dtype = gemm_dtype
        self.reorder_status = False
        self.layer_input: Optional[LayerConfig] = None
        self.layer_hidden: Optional[LayerConfig] = None
        self.hybrid_graph = None  # set by build_tensors for method="hybrid"

    def pad_features(self, a):
        """Node-indexed array -> the tensors' row space (the hybrid
        layout's padded rows; the identity for the other methods)."""
        if self.hybrid_graph is None:
            return a
        return self.hybrid_graph.pad_array(np.asarray(a))

    def unpad_outputs(self, a):
        if self.hybrid_graph is None:
            return a
        return self.hybrid_graph.unpad_array(np.asarray(a))

    # -- decision helpers ---------------------------------------------------

    def _auto_method(self) -> str:
        return "dense" if self.graph.num_nodes <= DENSE_MAX_NODES else "hybrid"

    def _auto_part_size(self) -> int:
        """The part size of least modelled cost: ``ELL_SLOT_NS`` per
        gathered slot (parts·p rows, padding included) plus
        ``ELL_PART_NS`` per neighbor group, over p in 2..64."""
        deg = np.diff(np.asarray(self.graph.row_pointers, dtype=np.int64))
        best, best_cost = 2, float("inf")
        for p in (2, 4, 8, 16, 32, 64):
            parts = int(-(-deg // p).sum()) if len(deg) else 1
            cost = ELL_SLOT_NS * parts * p + ELL_PART_NS * parts
            if cost < best_cost:
                best, best_cost = p, cost
        return best

    def _should_reorder(self) -> bool:
        # the reference's heuristic, param.py:110
        g = self.graph
        return math.sqrt(g.avg_edgeSpan) > math.sqrt(g.num_nodes) / 100.0

    # -- public API ---------------------------------------------------------

    def decider(self) -> "InputProperty":
        """Pick the method, part size, reordering and tiers; manual mode
        passes user values through (param.py:58-70).  The reorder comes
        first (param.py:110): the tiers measure the reordered locality."""
        if self.manual_mode:
            method = self.method or "ell"
            ps = self.part_size or 32
            if self.enable_reorder:
                self.reorder_status = True
        else:
            method = self.method or self._auto_method()
            ps = self.part_size or self._auto_part_size()
            self.part_size = ps
            if self.enable_reorder:
                self.reorder_status = self._should_reorder()
        if method not in METHODS:
            raise ValueError(f"unknown aggregation method: {method}")
        if self.reorder_status:
            self.graph = reorder.rabbit_reorder_graph(self.graph)
        if method == "hybrid":
            g = self.graph
            src = np.repeat(
                np.arange(g.num_nodes, dtype=np.int64),
                np.diff(np.asarray(g.row_pointers, dtype=np.int64)),
            )
            self.diag_b, self.hot_k = choose_tiers(
                src, np.asarray(g.column_index, dtype=np.int64), g.num_nodes,
                hot_k=self.hot_k, diag_b=self.diag_b,
            )
        self.layer_input = LayerConfig(method, ps, self.input_dim)
        self.layer_hidden = LayerConfig(method, ps, self.hidden_dim)
        if self.verbose:
            mode = "MANUAL" if self.manual_mode else "AUTO"
            print(f"# {mode} input  layer: {self.layer_input}")
            print(f"# {mode} hidden layer: {self.layer_hidden}")
            if method == "hybrid":
                print(f"# hybrid tiers: diag_b={self.diag_b} hot_k={self.hot_k}")
            print(f"# reorder: {self.reorder_status}")
        return self

    def build_tensors(
        self, device=None
    ) -> tuple[HybridTensors, HybridTensors] | tuple[GraphTensors, GraphTensors]:
        """The (input-layer, hidden-layer) tensors on ``device`` (None: the
        card).  Both layers share one tensor set: the decider gives them
        one method and part size, and the hybrid residual kernels gather
        by ``res_src`` at any width.  The hybrid method also builds the
        padded-row layout (``pad_features``/``unpad_outputs`` move node
        data in and out)."""
        if self.layer_input is None:
            raise RuntimeError("call decider() first")
        dev = resolve_device(device)
        li = self.layer_input
        if li.method != "hybrid":
            groups = None
            if li.method == "ell":
                groups = build_neighbor_groups(
                    self.graph.row_pointers, self.graph.column_index,
                    li.part_size,
                )
                if self.verbose:
                    print(f"# ell padding waste: {groups.padding_waste:.3f}")
            gt = build_graph_tensors(
                self.graph, method=li.method, groups=groups, device=dev,
                gemm_dtype=self.gemm_dtype,
            )
            return gt, gt
        # the user's values, not the decider's: build_hybrid re-prices the
        # tiers at the residual geometry it builds, as the JAX build does,
        # and the probe may override the model's pick on the card
        hg = self.hybrid_graph = build_hybrid(
            self.graph, hot_k=self._user_hot_k, diag_b=self._user_diag_b,
            probe=self.probe, device=dev,
        )
        if (hg.diag_b, hg.hot_k) != (self.diag_b, self.hot_k):
            if self.verbose:
                print(f"# probe autotune: measured ({hg.diag_b},{hg.hot_k}) "
                      f"over model ({self.diag_b},{self.hot_k})")
            self.diag_b, self.hot_k = hg.diag_b, hg.hot_k
        if self.verbose:
            print(f"# tier probe: {hg.tier_probe}; built tiers diag_b="
                  f"{hg.diag_b} hot_k={hg.hot_k}")
        return build_layer_tensors(
            hg, device=dev, agg_dtype=self.agg_dtype,
            transposed=self.transposed is not False,
            gemm_dtype=self.gemm_dtype,
        )

    def agg_dims(self) -> tuple[int, int]:
        """The widths the input and hidden layers aggregate at
        (tuner/decider.py:355-361 in the JAX package)."""
        if self.model == "gin":
            return self.input_dim, self.hidden_dim
        return self.hidden_dim, self.graph.num_classes
