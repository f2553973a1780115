"""frame_p95_ms: the 95th percentile, over every frame that reached the
sink inside the window, of the host milliseconds from the start of its
production (its first draw call, or its submit) to its arrival."""

from ..harness.timeline import p95

UNIT = "ms"


def read(run):
    return p95(run.latencies_ms)
