"""The inputs of one run, drawn from ``--seed``: features, labels and the
model's initial weights, made on the device in a few large calls.  The
harness hands the same tensors to the program and to the reference."""

from __future__ import annotations

import torch


def widths(config: dict, traffic: dict) -> list[int]:
    """The layers' widths, input to output: GCN ``[F, H, C]``, GIN ``[F,
    H, H, H, H, C]`` at 5 layers."""
    layers = int(config["num_layers"])
    return ([int(traffic["features"])] + [int(config["hidden"])] * (layers - 1)
            + [int(traffic["classes"])])


def param_names(config: dict) -> list[str]:
    """The weights' names, as the port's models call them."""
    return [f"conv{i + 1}" for i in range(int(config["num_layers"]))]


def make_inputs(seed: int, config: dict, traffic: dict, device):
    """(x [N, F] float32 standard normal, labels [N] int64 uniform over the
    classes, [W_1..W_L] float32 uniform in +-1/sqrt(fan_out)), all from
    one generator on ``device`` seeded with ``seed``."""
    n = int(traffic["nodes"])
    ws = widths(config, traffic)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn((n, ws[0]), generator=gen, device=device)
    labels = torch.randint(0, ws[-1], (n,), generator=gen, device=device)
    shapes = list(zip(ws[:-1], ws[1:]))
    flat = torch.rand(sum(a * b for a, b in shapes), generator=gen,
                      device=device)
    params, at = [], 0
    for a, b in shapes:
        bound = 1.0 / float(b) ** 0.5
        params.append((flat[at:at + a * b].view(a, b) * 2 - 1) * bound)
        at += a * b
    return x, labels, params
