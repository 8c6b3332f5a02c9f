"""GNNAdvisor on PyTorch and CUDA: the port of ``gnnadvisor_osdi21_tpu``
to an NVIDIA H100.

It imports nothing of the JAX package.  The hybrid layout's three
transposed kernels are CUDA C++ in ``csrc/``, built at first use by
``ops/_build.py``.  Entry points run on the card unless the caller passes
``device="cpu"``, which runs each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
