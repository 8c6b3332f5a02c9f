"""attn_ms: milliseconds a step's attention kernels ran on the card in the
profiled window of replays of the captured step: the port's kernels in
the namespace ``gat::`` of its CUDA sources (the edge softmax, the SDDMM
with the softmax's backward, the logits' column sums), summed over the
window, over its steps.  The alpha-weighted aggregations (``gnna::``)
are ``agg_ms``'s.  None where the window ran no such kernel."""

ATTN_KERNELS = "gat::"


def read(ctx):
    t = ctx.trace
    if not ctx.on_card or t is None or not t.steps:
        return None
    total = sum(s for name, s in t.kernel_s.items() if ATTN_KERNELS in name)
    return 1e3 * total / t.steps if total > 0 else None
