"""attn_roofline_pct: the step's attention work's least time over the time
its kernels took in the profiled window (``attn_ms``'s reading): for each
``"attn"`` operation of the model's module (the softmax, the SDDMM with
the softmax's backward, the logits' column sums; from the graph's N and
E, the widths and the stated operand precision only) the larger of its
bytes over the HBM rate and its FLOPs over the float32 peak, summed."""

from gnnbench import roofline

ATTN_KERNELS = "gat::"


def read(ctx):
    t = ctx.trace
    if not ctx.on_card or t is None or not t.steps or ctx.nodes is None:
        return None
    measured = sum(s for name, s in t.kernel_s.items()
                   if ATTN_KERNELS in name) / t.steps
    if measured <= 0:
        return None
    cfg = ctx.cell.config
    operand = roofline.DTYPE_BYTES[cfg["precision"]["agg_operands"]]
    ops = roofline.step_ops(ctx.cell.model, ctx.nodes, ctx.edges, ctx.widths,
                            operand)
    bound = sum(max(op.bytes / roofline.HBM_BYTES_PER_S,
                    op.flops / roofline.F32_FLOPS)
                for op in ops if op.kind == "attn")
    return 100.0 * bound / measured
