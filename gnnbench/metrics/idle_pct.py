"""idle_pct: the share of the profiled window in which no operation ran
on the card: 1 - (union of the device operations' intervals) / window."""


def read(ctx):
    t = ctx.trace
    if not ctx.on_card or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
