"""The benchmark of the PyTorch and CUDA port (``gnnadvisor_osdi21_tpu_torch``).

One command runs one cell (a model configuration under a traffic mix)
once::

    python3 -m gnnbench.run --workload gcn.amazon0505 --seed 7 --seconds 10 --trace 0

Cells, configurations, traffic mixes and per-layer metrics are named in
``BENCHMARK.json`` at the repository's root and found here by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<workload>.json``; and a
configuration's model by its ``model``, ``models/<model>.py`` (its
weights, widths, reference forward pass and roofline counts:
``spec.Model``).
"""
