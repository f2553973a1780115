"""The benchmark's own host-clock record of a run: the sink that stamps
each frame's arrival and keeps a seeded sample of the frames, the span
totals of the calls into each layer, and the window's statistics."""

from __future__ import annotations

import time

import numpy as np

clock = time.perf_counter_ns


class Sink:
    """A frame sink with ``put_frame_u8``.  A frame is the unit a system
    delivers here, whatever its dtype: a u8 video frame, or one mixed
    clip for a mixer.  The sink stamps each frame's arrival on the host
    clock and keeps a copy of ``per_slot`` frames of each of the
    ``slots`` places in a batch (frame i's is ``i % slots``), drawn from
    ``rng`` by reservoir sampling, so that every place in a batch is
    checked and the sample does not depend on how many frames the window
    holds; the rest are dropped, as an encoder drops a frame once it has
    encoded it.  ``callback_ns`` is the time spent in here, which the
    pipeline's span leaves out.  With ``ranges`` each callback is a
    ``bench.sink`` profiler range."""

    def __init__(self, rng: np.random.Generator, slots: int = 1,
                 per_slot: int = 1):
        self.rng = rng
        self.slots, self.per_slot = slots, per_slot
        self.ranges = False
        self.reset()

    def reset(self) -> None:
        self.arrivals: list = []
        self.sample: dict = {}
        self.kept: list = [[] for _ in range(self.slots)]
        self.callback_ns = 0

    def put_frame_u8(self, frame) -> None:
        if self.ranges:
            from torch.profiler import record_function
            with record_function("bench.sink"):
                self._put(frame)
        else:
            self._put(frame)

    def _put(self, frame) -> None:
        t = clock()
        i = len(self.arrivals)
        self.arrivals.append(t)
        kept = self.kept[i % self.slots]
        seen = i // self.slots + 1          # frames of this slot so far
        if seen <= self.per_slot:
            kept.append(i)
            self.sample[i] = np.array(frame)
        else:
            j = int(self.rng.integers(0, seen))
            if j < self.per_slot:
                del self.sample[kept[j]]
                kept[j] = i
                self.sample[i] = np.array(frame)
        self.callback_ns += clock() - t


class Spans:
    """Total host nanoseconds and calls of each named span."""

    def __init__(self):
        self.ns: dict = {}
        self.calls: dict = {}

    def add(self, name: str, ns: int) -> None:
        self.ns[name] = self.ns.get(name, 0) + ns
        self.calls[name] = self.calls.get(name, 0) + 1


def window_latencies_ms(starts, arrivals, t_end: int) -> np.ndarray:
    """Start-to-arrival milliseconds of every frame that arrived by
    ``t_end`` (frame i arrives i-th: the pipelines keep their order)."""
    n = min(len(starts), len(arrivals))
    s = np.asarray(starts[:n], np.int64)
    a = np.asarray(arrivals[:n], np.int64)
    keep = a <= t_end
    return (a[keep] - s[keep]) / 1e6


def p95(values) -> float | None:
    """The 95th percentile (linear between order statistics) of all the
    values, or None for none."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95))
