"""GNNAdvisor on PyTorch and CUDA: the port of ``gnnadvisor_osdi21_tpu``
to an NVIDIA H100.

It imports nothing of the JAX package.  The hybrid layout's kernels are
CUDA C++ in ``csrc/``, built at first use by ``ops/_build.py``; the ELL,
dense and COO paths are PyTorch ops; the reordering pass and the text
edge-list parser are C++ (``native/graphtools.cpp``), built at first use
with ``g++``.  Entry points run on the card unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

from gnnadvisor_osdi21_tpu_torch.graphs.loader import (
    GraphCSR, load_graph, synthesize_graph,
)
from gnnadvisor_osdi21_tpu_torch.graphs.partition import (
    NeighborGroups, build_neighbor_groups,
)
from gnnadvisor_osdi21_tpu_torch.graphs.reorder import rabbit_reorder_graph
from gnnadvisor_osdi21_tpu_torch.ops.graph_tensors import build_graph_tensors
from gnnadvisor_osdi21_tpu_torch.tuner.decider import InputProperty

__all__ = [
    "GraphCSR",
    "load_graph",
    "synthesize_graph",
    "NeighborGroups",
    "build_neighbor_groups",
    "rabbit_reorder_graph",
    "build_graph_tensors",
    "InputProperty",
]
