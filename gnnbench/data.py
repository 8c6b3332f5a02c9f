"""The inputs of one run, drawn from ``--seed``: features, labels and the
model's initial weights, made on the device in a few large calls.  The
harness hands the same tensors to the program and to the reference."""

from __future__ import annotations

import math

import torch


def make_inputs(seed: int, model, traffic: dict, device):
    """(x [N, F] float32 standard normal, labels [N] int64 uniform over the
    classes, the weights of ``model`` (``spec.Model``) float32, each
    uniform in +-its bound, in its module's draw order), all from one
    generator on ``device`` seeded with ``seed``."""
    n = int(traffic["nodes"])
    ws = model.arch.widths(model.config, traffic)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn((n, ws[0]), generator=gen, device=device)
    labels = torch.randint(0, ws[-1], (n,), generator=gen, device=device)
    draws = [(shape, bound) for _, shape, bound
             in model.arch.weights(model.config, traffic)]
    flat = torch.rand(sum(math.prod(shape) for shape, _ in draws),
                      generator=gen, device=device)
    params, at = [], 0
    for shape, bound in draws:
        size = math.prod(shape)
        params.append((flat[at:at + size].view(shape) * 2 - 1) * bound)
        at += size
    return x, labels, params
