"""The port's timing helpers (``utils/timing.py``) and ``train_and_time``'s
window plan and two-point fit, under a fake clock or fixed numbers.

The helpers' arithmetic is exact under a fake clock whose time moves only
when the test says so; the tolerance (rel 1e-9) covers float rounding of
the sums only."""

import numpy as np
import pytest
import torch

from gnnadvisor_osdi21_tpu_torch import train
from gnnadvisor_osdi21_tpu_torch.utils import timing

REL = 1e-9


class FakeClock:
    """Host time that moves by ``fixed`` at every reading and by ``slope``
    at every op call: a run of n calls reads n·slope + fixed."""

    def __init__(self, slope: float, fixed: float):
        self.t, self.slope, self.fixed = 0.0, slope, fixed
        self.calls = 0

    def now(self) -> float:
        self.t += self.fixed
        return self.t

    def op(self, x, aux=None):
        self.calls += 1
        self.t += self.slope
        return x


@pytest.mark.parametrize("slope, fixed", (
    (2e-3, 5e-2), (1e-5, 2.5e-2), (3e-4, 0.0),
))
def test_chained_marginal_time_recovers_slope_and_intercept(
    slope, fixed, monkeypatch
):
    clock = FakeClock(slope, fixed)
    monkeypatch.setattr(timing, "_now", clock.now)
    x = torch.zeros(4)
    marginal, fix = timing.chained_marginal_time(
        clock.op, x, iters=50, reps=3, quad=4
    )
    assert marginal == pytest.approx(slope, rel=REL)
    assert fix == pytest.approx(fixed, rel=REL, abs=1e-12)
    # (1 warm-up + 3 timed runs) at 50 and at 200 calls
    assert clock.calls == 4 * 50 + 4 * 200


def test_chained_device_time_takes_the_least_run(monkeypatch):
    """A run slowed by the host (one noisy rep) does not count: the least
    of ``reps`` runs, per call."""
    clock = FakeClock(1e-3, 0.0)
    monkeypatch.setattr(timing, "_now", clock.now)
    extra = iter([0.0, 0.5, 0.0, 0.0])  # warm-up, then three reps

    def op(x, aux):
        if clock.calls % 10 == 0:
            clock.t += next(extra)
        return clock.op(x, aux)

    stats = {}
    sec = timing.chained_device_time(op, torch.zeros(2), aux="graph",
                                     iters=10, reps=3, stats=stats)
    assert sec == pytest.approx(1e-3, rel=REL)
    assert stats["host_s"] == pytest.approx(1e-3, rel=REL)


def test_chained_helpers_pass_aux_through():
    seen = []
    timing.chained_device_time(lambda x, a: seen.append(a) or x,
                               torch.zeros(1), aux="tensors", iters=2, reps=1)
    timing.chained_device_time(lambda x: seen.append(None) or x,
                               torch.zeros(1), iters=2, reps=1)
    assert set(seen) == {"tensors", None}


def test_timing_needs_a_tensor():
    with pytest.raises(TypeError):
        timing.chained_device_time(lambda x: x, np.zeros(2), iters=1, reps=1)


def test_dispatch_floor_on_the_cpu():
    sec = timing.dispatch_floor(iters=5, reps=2, device="cpu")
    assert 0.0 < sec < 1.0


# --- train_and_time's protocol -------------------------------------------------


@pytest.mark.parametrize("num_epochs, plan", (
    (64, (8, 8, 1, 8)),  # chip_smoke's phases 3 and 5
    (200, (25, 8, 3, 8)),  # the reference's default epochs
    (20, (2, 10, 0, 0)),  # too short for a second window size: no fit
    (3, (1, 8, 0, 0)),  # fewer epochs than windows: 8 windows of 1
    (1000, (125, 8, 15, 8)),
))
def test_timing_plan(num_epochs, plan):
    chunk, n_exec, chunk2, n2 = train.timing_plan(num_epochs)
    assert (chunk, n_exec, chunk2, n2) == plan
    assert n_exec >= train.MIN_WINDOWS and n_exec * chunk >= num_epochs


def test_marginal_fit_recovers_slope_and_intercept():
    """Windows of 8 epochs at 3 ms + 0.5 ms fixed, of 1 epoch at 3.5 ms;
    one outlier in each set moves no median."""
    w1 = [24.5] * 7 + [90.0]
    w2 = [3.5] * 7 + [40.0]
    epoch_ms, fixed_ms = train.marginal_fit(w1, w2, 8, 1)
    assert epoch_ms == pytest.approx(3.0, rel=REL)
    assert fixed_ms == pytest.approx(0.5, rel=REL)


def test_marginal_fit_falls_back_to_the_mean():
    # no second set
    assert train.marginal_fit([10.0, 14.0], [], 2, 0) == (6.0, 0.0)
    # noise inverted the fit: the short windows ran slower per window
    epoch_ms, fixed_ms = train.marginal_fit([8.0] * 8, [9.0] * 8, 8, 1)
    assert (epoch_ms, fixed_ms) == (1.0, 0.0)
