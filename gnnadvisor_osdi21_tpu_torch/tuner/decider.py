"""The input-adaptive parameter decider ("Advisor") for the hybrid path.

The port of ``gnnadvisor_osdi21_tpu/tuner/decider.py`` for
``method="hybrid"``: the tier sizes ``diag_b``/``hot_k`` come from the
cost model over the graph's degree and locality structure
(``graphs/hybrid.choose_tiers``) unless the user fixes them, and the
layout's tensors are shared by both layers.  Auto choices equal the JAX
decider's with its probe off.  The JAX decider's VMEM model
(decider.py:49-56, 200-224) sized TPU grid steps; the CUDA kernels size
their own launches, so it is gone.

Models are the 2-layer GCN and the 5-layer GIN; the layout is transposed
(``transposed=None`` or True, the JAX default for the hybrid method) or
row-major (``transposed=False``).  ``probe`` is the measured-probe tier
autotune (``graphs/hybrid.build_hybrid``): None probes auto tiers when the
layout is built for the card, as the JAX decider does on its TPU; False
trusts the cost model.  Not ported yet, and refused with
``NotImplementedError``: the ELL, dense and COO methods (ROADMAP.md item
A.4), manual mode (which defaults to ELL) and reordering (item A.3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from gnnadvisor_osdi21_tpu_torch.device import resolve_device
from gnnadvisor_osdi21_tpu_torch.graphs.hybrid import build_hybrid, choose_tiers
from gnnadvisor_osdi21_tpu_torch.graphs.loader import GraphCSR
from gnnadvisor_osdi21_tpu_torch.ops.hybrid_agg import (
    HybridTensors, build_layer_tensors,
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
        probe: Optional[bool] = None,
    ):
        if model not in ("gcn", "gin"):
            raise ValueError(f"unknown model: {model}")
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
        self.model = model
        self.manual_mode = manual_mode
        self.verbose = verbose
        self.agg_dtype = agg_dtype
        self.transposed = transposed
        self.probe = probe
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
        """Build the layout and put it on ``device`` (None: the card): one
        tensor set for both layers, whatever widths they aggregate at
        (``agg_dims``), since the residual kernels gather by ``res_src``
        at any width."""
        if self.layer_input is None:
            raise RuntimeError("call decider() first")
        dev = resolve_device(device)
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
            # the tier-dependent geometry: the CUDA kernels size their own
            # launches, so the tiers themselves are all there is to refresh
            self.diag_b, self.hot_k = hg.diag_b, hg.hot_k
        return build_layer_tensors(
            hg, device=dev, agg_dtype=self.agg_dtype,
            transposed=self.transposed is not False,
        )

    def agg_dims(self) -> tuple[int, int]:
        """The widths the input and hidden layers aggregate at
        (tuner/decider.py:355-361 in the JAX package)."""
        if self.model == "gin":
            return self.input_dim, self.hidden_dim
        return self.hidden_dim, self.graph.num_classes
