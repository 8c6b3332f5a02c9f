"""agg_passes_ms: card milliseconds of one training step in the
aggregation's dense passes, forward and backward: every
``aggregate.passes`` span (the row table's scale, cast and transpose, the
output's degree scale and cast) inside the warm-up's timed step (span
``warm_up.timed_step``, whose spans carry CUDA-event times).  None off
the card or where the program keeps no such spans."""

STEP = "warm_up.timed_step"


def read(ctx):
    if not ctx.on_card:
        return None
    try:
        from gnnadvisor_osdi21_tpu_torch.utils import profiling
    except ImportError:
        return None
    store = getattr(profiling, "STORE", None)
    step = store.latest(STEP) if store is not None else None
    if step is None or step.device_s is None:
        return None
    passes = [r for r in store.descendants(step)
              if r.name == "aggregate.passes"]
    if not passes or any(r.device_s is None for r in passes):
        return None
    return 1e3 * sum(r.device_s for r in passes)
