"""edge_layout_s: host seconds the port spends building the attention
layout's edges: the span ``layout.edges`` (the self-loops, the row-owner
and transposed orders with their permutation, the chunks) inside the
last ``layout``, in the program's span store (``utils/profiling.py``).
None where the program keeps no such span."""


def read(ctx):
    try:
        from gnnadvisor_osdi21_tpu_torch.utils import profiling
    except ImportError:
        return None
    store = getattr(profiling, "STORE", None)
    rec = store.latest("layout") if store is not None else None
    if rec is None:
        return None
    spans = [c for c in store.children(rec) if c.name == "layout.edges"]
    return sum(c.seconds for c in spans) if spans else None
