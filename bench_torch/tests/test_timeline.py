"""The rate and the p95 come from every frame of the window, and a stall
in the window moves both; the sink's sample is seeded."""

import numpy as np
import pytest

from bench_torch.harness import timeline
from bench_torch.harness.main import Run
from bench_torch.metrics import frame_p95_ms, frames_per_s


def steady(n=400, period_ms=5.0, batch=16, stall_at=None, stall_ms=0.0):
    """Starts and arrivals (ns) of a closed loop: frame k starts one
    period after frame k-1, its batch arrives one batch behind; a stall
    delays every start from ``stall_at`` on."""
    starts, arrivals = [], []
    t = 0.0
    for k in range(n):
        if k == stall_at:
            t += stall_ms
        starts.append(t)
        t += period_ms
    for k in range(n):
        b = k // batch
        done = starts[min(n - 1, (b + 2) * batch - 1)]
        arrivals.append(done)
    return ([int(s * 1e6) for s in starts], [int(a * 1e6) for a in arrivals])


def run_of(starts, arrivals, window_ms, batch=16):
    t_end = int(window_ms * 1e6)
    lat = timeline.window_latencies_ms(starts, arrivals, t_end)
    return Run(window_s=window_ms / 1e3,
               frames_in_window=sum(a <= t_end for a in arrivals),
               arrivals=[a for a in arrivals if a <= t_end], batch=batch,
               latencies_ms=lat)


def test_rate_and_p95_from_all_frames():
    s, a = steady()
    r = run_of(s, a, 1800.0)
    # every frame that arrived by the end counts; the rate runs from
    # the first whole batch's delivery to the last's
    assert r.frames_in_window == sum(x <= 1.8e9 for x in a)
    ends = [x for x in a if x <= 1.8e9][15::16]
    assert frames_per_s.read(r) == pytest.approx(
        (len(ends) - 1) * 16 / ((ends[-1] - ends[0]) / 1e9))
    assert frames_per_s.read(r) == pytest.approx(200.0)   # 5 ms a frame
    lat = (np.asarray(a) - np.asarray(s))[np.asarray(a) <= 1.8e9] / 1e6
    assert frame_p95_ms.read(r) == np.percentile(lat, 95)


def test_stall_moves_rate_and_tail():
    s, a = steady()
    base = run_of(s, a, 1800.0)
    s2, a2 = steady(stall_at=100, stall_ms=150.0)
    stalled = run_of(s2, a2, 1800.0)
    assert frames_per_s.read(stalled) < frames_per_s.read(base)
    assert frame_p95_ms.read(stalled) > frame_p95_ms.read(base) + 50


def test_rate_does_not_swing_with_the_window_edge():
    s, a = steady()
    rates = {round(frames_per_s.read(run_of(s, a, w)), 9)
             for w in (1800.0, 1830.0, 1860.0, 1879.0)}
    counts = {run_of(s, a, w).frames_in_window
              for w in (1800.0, 1830.0, 1860.0, 1879.0)}
    assert len(rates) == 1 and len(counts) > 1


def test_p95_none_without_frames():
    assert timeline.p95([]) is None
    assert frames_per_s.read(Run(window_s=1.0, frames_in_window=0)) is None


@pytest.mark.parametrize("slots,per_slot", [(8, 1), (16, 1), (8, 2)])
def test_sink_sample_is_seeded_and_uniform_in_size(slots, per_slot):
    def fill(seed, n=200):
        sink = timeline.Sink(np.random.default_rng(seed), slots, per_slot)
        for i in range(n):
            sink.put_frame_u8(np.full((2, 2, 4), i % 256, np.uint8))
        return sink
    a, b = fill(1), fill(1)
    assert sorted(a.sample) == sorted(b.sample)
    assert len(a.sample) == slots * per_slot
    assert sorted(i % slots for i in a.sample) == sorted(
        list(range(slots)) * per_slot)
    assert sorted(fill(2).sample) != sorted(a.sample)
    # the reservoir reaches past the first frames of each slot
    assert max(a.sample) >= 100
    assert len(a.arrivals) == 200
    for i, fr in a.sample.items():
        assert (fr == i % 256).all()
