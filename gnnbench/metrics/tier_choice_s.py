"""tier_choice_s: host seconds the port spends choosing the hybrid
layout's tiers: the span ``decider.choose_tiers`` inside the last
``decider``, and ``layout.tiers`` (every pass of the tier and residual
geometry fixed point) and ``layout.probe`` inside the last ``layout``, in
the program's span store (``utils/profiling.py``).  None where the
program keeps no such spans."""

NAMES = {"decider": ("decider.choose_tiers",),
         "layout": ("layout.tiers", "layout.probe")}


def read(ctx):
    try:
        from gnnadvisor_osdi21_tpu_torch.utils import profiling
    except ImportError:
        return None
    store = getattr(profiling, "STORE", None)
    if store is None:
        return None
    total = 0.0
    for parent, names in NAMES.items():
        rec = store.latest(parent)
        if rec is None:
            return None
        total += sum(c.seconds for c in store.children(rec)
                     if c.name in names)
    return total
