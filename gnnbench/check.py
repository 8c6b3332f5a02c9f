"""The comparison that decides ``correct``: the program's first training
steps against the reference's, from the same seeded inputs.

The numbers, each compared where the cell's ``limits/<cell>.json`` gives
it a limit:

- ``loss1_gap``: the relative gap between the program's first loss and
  the reference's (the forward pass alone, before any update);
- ``loss_gap``: the largest such gap over the first steps;
- ``grad_gap``: over the weights (leaves), the largest gap between the
  norm of the program's first gradient (as Adam got it) and the norm of
  the reference's, over the larger of that leaf's reference norm and the
  median leaf's;
- ``grad_diff``: over the leaves, the largest norm of the difference of
  the two first gradients, over the same denominator;
- ``delta_gap``: ``grad_gap``'s measure for each weight's change after
  the first steps.  Leaves whose reference gradient is under a thousandth
  of the median leaf's move by round-off alone and are left out.

A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics

SMALL_LEAF = 1e-3  # relative to the median leaf's first gradient


def _norms(tensors) -> list[float]:
    return [float(t.double().norm()) for t in tensors]


def _worst_gap(prog: list[float], ref: list[float],
               leaves: list[int]) -> float:
    med = statistics.median(ref)
    return max((_rel(prog[i], ref[i]) * ref[i] / max(ref[i], med)
                if ref[i] else _rel(prog[i], med) for i in leaves),
               default=0.0)


def _rel(p: float, r: float) -> float:
    gap = abs(p - r) / abs(r) if r else (0.0 if p == r else math.inf)
    return gap if math.isfinite(gap) else math.inf


def compare(prog: dict, ref: dict) -> dict:
    """The numbers; ``prog`` and ``ref`` hold ``losses``, ``grad1`` and
    ``delta`` (one tensor a leaf, in the same order)."""
    losses = [_rel(p, r) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not losses:
        losses.append(math.inf)
    g_ref = _norms(ref["grad1"])
    med = statistics.median(g_ref)
    moved = [i for i, g in enumerate(g_ref) if g >= SMALL_LEAF * med]
    diff = _norms([p.double() - r.double()
                   for p, r in zip(prog["grad1"], ref["grad1"])])
    return {
        "loss1_gap": losses[0],
        "loss_gap": max(losses),
        "grad_gap": _worst_gap(_norms(prog["grad1"]), g_ref,
                               list(range(len(g_ref)))),
        "grad_diff": max((d / max(g, med) if max(g, med) else
                          (0.0 if d == 0 else math.inf))
                         for d, g in zip(diff, g_ref)),
        "delta_gap": _worst_gap(_norms(prog["delta"]), _norms(ref["delta"]),
                                moved),
    }


def verdict(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
