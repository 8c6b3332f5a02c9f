"""kernels_per_step: kernels the card ran in the profiled window over the
captured step's replays in it (the window starts and ends synchronised,
so it holds whole steps)."""


def read(ctx):
    t = ctx.trace
    if not ctx.on_card or t is None or t.kernels == 0 or t.steps == 0:
        return None
    return t.kernels / t.steps
