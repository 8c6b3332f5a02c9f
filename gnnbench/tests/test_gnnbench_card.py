"""On the card, at a cell's own size: the program's first steps pass the
cell's limits, and each control (the reference with int8 aggregation
operands, and with TF32 GEMM operands, in the program's place) and the
half-batch fault fail them.  Skips without a card; run it there with
``python3 -m pytest gnnbench/tests -m card``."""

from __future__ import annotations

import pytest

from gnnbench import calibrate, check, spec


@pytest.mark.card
@pytest.mark.parametrize("cell", ["gcn.amazon0505", "gin.amazon0505",
                                  "gin.yeast", "gcn.yeast"])
def test_control_fails_at_the_cells_size(card, cell):
    c = spec.Cell(cell)
    seeds = [2200000000 + 7919 * i for i in range(3)]
    _, kinds = calibrate.readings(c, seeds, control=3, faults=3, device=card,
                                  emit=lambda line: None)
    assert all(check.verdict(r, c.limits) for r in kinds["program"])
    for kind in ("control_int8", "control_tf32", "half_batch"):
        assert len(kinds[kind]) == 3
        assert not any(check.verdict(r, c.limits) for r in kinds[kind])
