"""load_s: host seconds of the port's graph load, the span ``graph.load``
(the edge file's parse and the CSR build) in the program's span store
(``utils/profiling.py``).  None where the program keeps no such span."""


def read(ctx):
    try:
        from gnnadvisor_osdi21_tpu_torch.utils import profiling
    except ImportError:
        return None
    store = getattr(profiling, "STORE", None)
    rec = store.latest("graph.load") if store is not None else None
    return None if rec is None else rec.seconds
