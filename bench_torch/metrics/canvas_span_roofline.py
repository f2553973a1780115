"""canvas_span_roofline: K4's least time for the profiled frames' draw
calls and texture blits (``rooflines/canvas_span``) over the device time
of the kernels of the cell's library (its system's ``LIBRARY``) in the
profiled sub-window.  Layer: canvas kernel."""

from ..harness import peaks
from ..rooflines import canvas_span

UNIT = "%"


def read(run):
    if run.trace is None or "canvas_span" not in run.work:
        return None
    t = run.trace.library_kernel_s(run.library)
    if not t:
        return None
    return 100.0 * peaks.bound_s(*canvas_span.work(run.work["canvas_span"])) / t
