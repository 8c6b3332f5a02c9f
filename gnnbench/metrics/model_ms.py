"""model_ms: card milliseconds of one training step outside the
aggregation's tiers and Adam: the GEMMs, the aggregation's dense passes,
the activations, epsilon scaling and the loss, forward and backward.
Read from the warm-up's timed step (span ``warm_up.timed_step``, whose
spans carry CUDA-event times, the card held until the host had queued
the whole step): its top-level spans' device time, less every
``aggregate.tiers`` and ``adam`` span inside it.  None off the card or
where the program keeps no such spans."""

STEP = "warm_up.timed_step"
OUTSIDE = ("aggregate.tiers", "adam")


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
    top = store.children(step)
    inner = [r for r in store.descendants(step) if r.name in OUTSIDE]
    if not top or any(r.device_s is None for r in top + inner):
        return None
    return 1e3 * (sum(r.device_s for r in top)
                  - sum(r.device_s for r in inner))
