"""agg_ms: milliseconds a step's aggregation kernels ran on the card in
the profiled window of replays of the captured step: the port's own
kernels (``tracing.AGG_KERNELS``: the slab tiers and the residual),
summed over the window, over its steps.  The operand casts and the
degree scaling around them are the model layer's passes, not counted."""

from gnnbench import tracing


def read(ctx):
    s = tracing.agg_step_s(ctx.trace) if ctx.on_card else None
    return None if s is None else 1e3 * s
