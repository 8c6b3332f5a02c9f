"""agg_roofline_pct: the step's aggregations' least time over the time
their kernels took in the profiled window (``agg_ms``'s reading): for each
aggregation of the step the larger of its bytes over the HBM rate and its
FLOPs over the bf16 peak (``gnnbench/roofline.py`` and the model's
module, from the graph's N and E, the widths and the stated operand
precision only), summed."""

from gnnbench import roofline, tracing


def read(ctx):
    measured = tracing.agg_step_s(ctx.trace) if ctx.on_card else None
    if measured is None or ctx.nodes is None:
        return None
    cfg = ctx.cell.config
    operand = roofline.DTYPE_BYTES[cfg["precision"]["agg_operands"]]
    ops = roofline.step_ops(ctx.cell.model, ctx.nodes, ctx.edges, ctx.widths,
                            operand)
    bound = sum(roofline.agg_bound_s(op) for op in ops if op.kind == "agg")
    return 100.0 * bound / measured
