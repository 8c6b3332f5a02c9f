"""step_mfu_pct: the whole training step's least time over the measured
``epoch_ms`` of the same run: the larger of its GEMMs' FLOPs over the
configuration's GEMM peak and its GEMMs' and aggregations' bytes over
the HBM rate (``gnnbench/roofline.step_ops``, as the model's module
counts them from N, E, its widths and the stated operand precision
only)."""

from gnnbench import roofline


def read(ctx):
    if not ctx.on_card or ctx.epoch_ms is None or ctx.nodes is None:
        return None
    prec = ctx.cell.config["precision"]
    ops = roofline.step_ops(ctx.cell.model, ctx.nodes, ctx.edges,
                            ctx.widths, roofline.DTYPE_BYTES[prec["agg_operands"]])
    least = roofline.step_bound_s(ops, prec["gemm"])
    return 100.0 * least / (ctx.epoch_ms / 1e3)
