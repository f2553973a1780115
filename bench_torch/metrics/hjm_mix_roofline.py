"""hjm_mix_roofline: the least time of the profiled mixes of the MIDI
mixer (``rooflines/hjm_mix``: bytes over the memory's rate or operations
over the float32 rate, whichever is larger) over the device time of
their kernels, device-to-device copies and fills in the profiled
sub-window; copies between host and device are left out (the PCM's copy
to the host is the sink's, not the engine's), as ``audio_mix_roofline``
reads.  Layer: audio scatter routes."""

from ..harness import peaks
from ..rooflines import hjm_mix

UNIT = "%"
HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH", "Memcpy HtoH")


def read(run):
    if run.trace is None or "hjm_mix" not in run.work:
        return None
    t = sum(s for name, s in run.trace.device_by_name.items()
            if not name.startswith(HOST_COPIES))
    if not t:
        return None
    return 100.0 * peaks.bound_s(*hjm_mix.work(run.work["hjm_mix"])) / t
