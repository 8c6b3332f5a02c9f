"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one that raises instead of
    running on the CPU.  Pass ``"cpu"`` to run the plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'"
        )
    return dev
