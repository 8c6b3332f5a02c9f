"""The controls and the planted fault at a size a test run holds: the
reference one precision below the configuration's (int8 aggregation
operands; TF32 GEMM operands), and the reference with half of the nodes
left out of the loss, each in the program's place, fail a tiny cell's
limits on every seed where the program's own first steps pass them."""

from __future__ import annotations

import pytest

from gnnbench import calibrate, check, spec


@pytest.mark.parametrize("cell", ["gcn.tiny", "gin.tiny"])
def test_control_and_fault_fail_where_the_program_passes(harness, cell):
    c = spec.Cell(cell, harness)
    _, kinds = calibrate.readings(c, [3000000001, 3000007920], control=2,
                                  faults=2, device="cpu",
                                  emit=lambda line: None)
    assert all(check.verdict(r, c.limits) for r in kinds["program"])
    for kind in ("control_int8", "control_tf32", "half_batch"):
        assert len(kinds[kind]) == 2
        assert not any(check.verdict(r, c.limits) for r in kinds[kind])
