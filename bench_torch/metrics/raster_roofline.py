"""raster_roofline: the mesh raster's least time for the profiled frames
(``rooflines/raster``: bytes over the memory's rate or operations over
the float32 rate, whichever is larger) over the device time of the
kernels of the cell's library (its system's ``LIBRARY``) in the profiled
sub-window.  Layer: mesh kernels."""

from ..harness import peaks
from ..rooflines import raster

UNIT = "%"


def read(run):
    if run.trace is None or "raster" not in run.work:
        return None
    t = run.trace.library_kernel_s(run.library)
    if not t:
        return None
    return 100.0 * peaks.bound_s(*raster.work(run.work["raster"])) / t
