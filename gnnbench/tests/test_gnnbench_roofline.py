"""The roofline's counts, by hand on a 4-node, 5-edge graph."""

from __future__ import annotations

import pytest

from gnnbench import roofline


def test_aggregation_counts():
    # x in (4*2*4) + out (4*2*4) + column indices (5*4) + row pointers (5*4)
    op = roofline.agg(4, 5, 2, norm=False)
    assert (op.bytes, op.flops) == (104, 20)
    # the degree factors are the model layer's passes, outside the count
    assert roofline.agg(4, 5, 2, norm=True).bytes == 104
    # a bfloat16 operand: x in (4*2*2) + out (4*2*4) + 20 + 20
    assert roofline.agg(4, 5, 2, norm=False, operand=2).bytes == 88


def test_gemm_counts():
    op = roofline.gemm(3, 4, 5)
    assert (op.flops, op.bytes) == (120, (12 + 20 + 15) * 4)


def test_bounds():
    op = roofline.agg(4, 5, 2, norm=True)
    assert roofline.agg_bound_s(op) == pytest.approx(104 / 3.35e12)
    big = roofline.Op("agg", flops=10**15, bytes=1)
    assert roofline.agg_bound_s(big) == pytest.approx(10**15 / 989e12)


def test_gcn_step_by_hand():
    ops = roofline.step_ops("gcn", 4, 5, [3, 2, 2])
    # forward: X W1, Agg, H W2, Agg; backward: Agg, dW2, dH, Agg, dW1
    assert [o.kind for o in ops] == ["gemm", "agg", "gemm", "agg", "agg",
                                     "gemm", "gemm", "agg", "gemm"]
    assert [o.dim for o in ops if o.kind == "agg"] == [2, 2, 2, 2]
    assert all(o.norm for o in ops if o.kind == "agg")
    assert sum(o.flops for o in ops if o.kind == "gemm") == 48 + 32 + 32 + 32 + 48
    assert sum(o.bytes for o in ops) == 104 + 104 + 80 + 104 + 104 + 80 + 80 + 104 + 104
    assert roofline.step_bound_s(ops) == pytest.approx(
        max(192 / 67e12, 864 / 3.35e12))
    # bfloat16 operands: each of the 4 aggregations reads 4*2*2 bytes less
    half = roofline.step_ops("gcn", 4, 5, [3, 2, 2], operand=2)
    assert sum(o.bytes for o in half) == 864 - 4 * 16


def test_gin_step_by_hand():
    ops = roofline.step_ops("gin", 4, 5, [3, 2, 2])
    # forward: Agg(3), X W1, Agg(2), H W2; backward: dW2, dX2, Agg(2), dW1
    assert [(o.kind, o.dim) for o in ops] == [
        ("agg", 3), ("gemm", 0), ("agg", 2), ("gemm", 0), ("gemm", 0),
        ("gemm", 0), ("agg", 2), ("gemm", 0)]
    assert not any(o.norm for o in ops)
    assert sum(o.flops for o in ops if o.kind == "gemm") == 192
    assert sum(o.bytes for o in ops) == 136 + 104 + 104 + 80 + 80 + 80 + 104 + 104


def test_paper_models_aggregate_as_often_as_the_port():
    """GCN: 2 forward and 2 backward aggregations; GIN: 5 and 4."""
    gcn = roofline.step_ops("gcn", 10, 20, [96, 16, 22])
    gin = roofline.step_ops("gin", 10, 20, [96, 64, 64, 64, 64, 22])
    assert [o.dim for o in gcn if o.kind == "agg"] == [16, 22, 22, 16]
    assert [o.dim for o in gin if o.kind == "agg"] == [96, 64, 64, 64, 64,
                                                      64, 64, 64, 64]
