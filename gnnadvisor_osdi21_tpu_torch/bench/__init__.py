"""Measurement probes of the port, run on the card (``python -m
gnnadvisor_osdi21_tpu_torch.bench.<probe>``)."""
