"""The operations and bytes of a training step, and the card's peaks.

A model's module (``models/<model>.py``) lists the step's GEMMs and
aggregations with the shared tools here (``agg``, ``gemm``).  Counts
come from the graph's node count ``n``, its edge count ``e`` (duplicates
merged) and the model's widths only, never from a layout's tiers, so
they read the same work whatever layout or kernel does it.  A
roofline counts each input byte read once and each output byte written
once: an aggregation's operand at the precision the configuration states
for it (bfloat16, 2 bytes), float32 (4 bytes) for GEMM operands, weights
and every output, int32 (4 bytes) for the CSR's column indices and row
pointers.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet (dense, no sparsity, at
the full 700 W power limit).
"""

from __future__ import annotations

import dataclasses
import sys

from gnnbench import spec

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores, dense
TF32_FLOPS = 495e12  # tensor cores, dense
F32_FLOPS = 67e12  # outside the tensor cores
GEMM_PEAKS = {"float32": F32_FLOPS, "tf32": TF32_FLOPS, "bfloat16": BF16_FLOPS}
F32 = 4
IDX = 4
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


@dataclasses.dataclass(frozen=True)
class Op:
    """One GEMM or aggregation of a step: its kind, width(s), FLOPs and
    bytes."""

    kind: str  # "gemm" or "agg"
    flops: int
    bytes: int
    dim: int = 0  # an aggregation's width
    norm: bool = False  # an aggregation with GCN's degree factors


def agg(n: int, e: int, d: int, norm: bool, operand: int = F32) -> Op:
    """One aggregation at width ``d``: its operand (``operand`` bytes an
    element) read once, the float32 output written once, the CSR's column
    indices and row pointers read once; 2 FLOPs an edge and column.
    GCN's degree factors (``norm``) scale the operand and the output in
    passes of the model layer, outside the count."""
    nbytes = n * d * (operand + F32) + e * IDX + (n + 1) * IDX
    return Op("agg", 2 * e * d, nbytes, d, norm)


def gemm(m: int, k: int, n: int) -> Op:
    """[m, k] @ [k, n]: both operands read once, the output written once."""
    return Op("gemm", 2 * m * k * n, (m * k + k * n + m * n) * F32)


def agg_bound_s(op: Op) -> float:
    """The least time of an aggregation: the larger of its bytes over the
    HBM rate and its FLOPs over the bf16 tensor-core peak."""
    return max(op.bytes / HBM_BYTES_PER_S, op.flops / BF16_FLOPS)


def step_ops(model, n: int, e: int, widths: list[int],
             operand: int = F32) -> list[Op]:
    """The GEMMs and aggregations of one training step (forward and
    backward), as ``model``'s module counts them (its ``step_ops``).
    ``model``: a ``spec.Model``, or a model's name (its module under
    ``gnnbench/models/``, with no configuration).  ``operand``: the bytes
    of an aggregation operand's element."""
    if isinstance(model, str):
        model = spec.Model({"model": model})
    return model.arch.step_ops(model.config, sys.modules[__name__], n, e,
                               widths, operand)


def step_bound_s(ops: list[Op], gemm_dtype: str = "float32") -> float:
    """The step's least time: the larger of its GEMMs' FLOPs over the
    GEMM dtype's peak and all its bytes over the HBM rate."""
    flops = sum(op.flops for op in ops if op.kind == "gemm")
    nbytes = sum(op.bytes for op in ops)
    return max(flops / GEMM_PEAKS[gemm_dtype], nbytes / HBM_BYTES_PER_S)
