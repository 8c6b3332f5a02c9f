"""Kernel verification and single-SpMM profiling (the ``unitest.py``
analog): the port of ``gnnadvisor_osdi21_tpu/verification.py``.

Mirrors the reference harness: features are all-ones (unitest.py:27),
the aggregation on the tensors' device (the card, or the CPU's plain
versions) is compared against a CPU oracle (``torch_sparse.spmm`` there,
the port's COO ``index_add_`` here, ``ops/reference.py``;
unitest.py:33-40), and the pass criterion is an element mismatch
fraction below 1e-4 (unitest.py:54-63).  ``profile_spmm`` reproduces the
warm-up + N-round kernel timer (unitest.py:65-80) with the chained
timing of ``utils/timing.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnadvisor_osdi21_tpu_torch.ops import reference as ref
from gnnadvisor_osdi21_tpu_torch.ops.aggregate import is_transposed, sag
from gnnadvisor_osdi21_tpu_torch.utils.timing import chained_device_time


class Verification:
    """``sag`` over ``gt`` (one layer's tensors from
    ``InputProperty.build_tensors``) against the oracle, at width
    ``dim``."""

    def __init__(self, dim: int, prop, gt):
        self.dim = dim
        self.prop = prop
        self.gt = gt
        self.graph = prop.graph
        self.result = None
        self.result_ref = None

    def _ones(self) -> torch.Tensor:
        """All-ones features in the tensors' row space and orientation,
        on their device."""
        n_rows = getattr(self.gt, "num_rows", self.graph.num_nodes)
        shape = ((self.dim, n_rows) if is_transposed(self.gt)
                 else (n_rows, self.dim))
        return torch.ones(shape, dtype=torch.float32,
                          device=self.gt.degrees.device)

    def compute(self) -> np.ndarray:
        """Run the aggregation on all-ones features; [N, dim] numpy."""
        with torch.no_grad():
            out = sag(self._ones(), self.gt).cpu().numpy()
        if is_transposed(self.gt):
            out = out.T
        self.result = self.prop.unpad_outputs(out)
        return self.result

    def reference(self) -> np.ndarray:
        """CPU oracle: unweighted COO segment-sum (unitest.py:33-40)."""
        g = self.graph
        src = torch.from_numpy(ref.csr_to_coo(g.row_pointers, g.column_index))
        dst = torch.from_numpy(np.asarray(g.column_index))
        x = torch.ones((g.num_nodes, self.dim), dtype=torch.float32)
        self.result_ref = ref.sag(x, src, dst, g.num_nodes).numpy()
        return self.result_ref

    def compare(self, tolerance: float = 1e-4) -> bool:
        """Pass iff the mismatch fraction is below ``tolerance``
        (unitest.py:54-63).  Closeness is judged per compute dtype, as in
        the JAX package: float32 aggregation must match the oracle at f32
        accumulation tightness (rtol 1e-4, atol 1e-5), bfloat16 tier
        contractions at bf16 rounding (rtol 1e-2, atol 1e-3)."""
        agg_dtype = getattr(self.gt, "agg_dtype", "float32")
        if agg_dtype == "float32":
            rtol, atol = 1e-4, 1e-5
        else:
            rtol, atol = 1e-2, 1e-3
        close = np.isclose(self.result, self.result_ref, rtol=rtol, atol=atol)
        frac = 1.0 - close.mean()
        verdict = "PASSED" if frac < tolerance else "FAILED"
        print(f"# Verification {verdict} (mismatch fraction {frac:.2e}, "
              f"agg_dtype={agg_dtype})")
        return frac < tolerance

    def profile_spmm(self, rounds: int = 200) -> float:
        """Mean ms of one aggregation over ``min(rounds, 50)`` chained
        rounds (unitest.py:65-80; the JAX package's cap), the least of 3
        runs after a warm-up run (``chained_device_time``): card time
        between CUDA events on the card, the host's clock on the CPU."""
        with torch.no_grad():
            sec = chained_device_time(
                lambda a, g: sag(a, g), self._ones(), self.gt,
                iters=min(rounds, 50),
            )
        return sec * 1e3
