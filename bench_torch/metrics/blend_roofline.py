"""blend_roofline: the blended quad batch's least time for the profiled
frames (``rooflines/tile_blend``: bytes over the memory's rate or
operations over the float32 rate, whichever is larger) over the device
time of the kernels of the cell's library (its system's ``LIBRARY``,
K7) in the profiled sub-window.  Layer: blend kernel."""

from ..harness import peaks
from ..rooflines import tile_blend

UNIT = "%"


def read(run):
    if run.trace is None or "tile_blend" not in run.work:
        return None
    t = run.trace.library_kernel_s(run.library)
    if not t:
        return None
    return 100.0 * peaks.bound_s(*tile_blend.work(run.work["tile_blend"])) / t
