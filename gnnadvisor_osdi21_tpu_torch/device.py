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


def card_description(device=None) -> str:
    """Where ``device`` runs, for a record: ``cpu``, or the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (the card's name alone where
    ``nvidia-smi`` cannot say)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.splitlines()
        return out[dev.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)
