"""layout_pack_s: host seconds the port spends building the chosen
layout: the spans ``layout.pack_slabs`` (the slab tiers' bits),
``layout.residual_stream`` and ``layout.to_device`` (the tensors on the
card) inside the last ``layout``, in the program's span store
(``utils/profiling.py``).  None where the program keeps no such spans."""

NAMES = ("layout.pack_slabs", "layout.residual_stream", "layout.to_device")


def read(ctx):
    try:
        from gnnadvisor_osdi21_tpu_torch.utils import profiling
    except ImportError:
        return None
    store = getattr(profiling, "STORE", None)
    rec = store.latest("layout") if store is not None else None
    if rec is None:
        return None
    return sum(c.seconds for c in store.children(rec) if c.name in NAMES)
