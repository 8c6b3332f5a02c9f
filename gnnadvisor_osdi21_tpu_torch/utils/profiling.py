"""Profiling and roofline accounting: the port of
``gnnadvisor_osdi21_tpu/utils/profiling.py``.

The reference's profiling is cudaEvent timing plus GFLOPs printouts
behind ``#ifdef PROFILE`` (GNNAdvisor_kernel.cu:134-175); here it is a
``torch.profiler`` trace plus roofline accounting against the card's
memory rate.  The peaks are one NVIDIA H100 SXM's, from NVIDIA's data
sheet (dense rates, no sparsity, at the full 700 W power limit); the JAX
package's are a TPU v5e's and do not apply here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

# H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core rate, f32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
# traces go into the port's git-ignored cache directory unless told
_TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache",
    "trace")


@dataclasses.dataclass
class RooflineReport:
    seconds: float
    bytes_accessed: int
    flops: int

    @property
    def achieved_gbs(self) -> float:
        return self.bytes_accessed / self.seconds / 1e9

    @property
    def hbm_fraction(self) -> float:
        return self.bytes_accessed / self.seconds / HBM_BYTES_PER_S

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    def __str__(self) -> str:
        return (
            f"{self.seconds * 1e3:.3f} ms | {self.achieved_gbs:.0f} GB/s "
            f"({self.hbm_fraction * 100:.0f}% of HBM) | "
            f"{self.achieved_tflops:.2f} TFLOP/s"
        )


def spmm_roofline(seconds: float, nnz: int, dim: int, num_nodes: int,
                  dtype_bytes: int = 4) -> RooflineReport:
    """Roofline for one SpMM: must read every neighbor row once and write
    every output row once (the information-theoretic floor)."""
    bytes_accessed = (nnz + num_nodes) * dim * dtype_bytes
    return RooflineReport(seconds, bytes_accessed, 2 * nnz * dim)


@contextlib.contextmanager
def trace(log_dir: str = _TRACE_DIR):
    """``torch.profiler`` trace of the block, host and card, written as a
    Chrome trace into ``log_dir`` (open it in Perfetto or
    chrome://tracing); yields the profiler."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
