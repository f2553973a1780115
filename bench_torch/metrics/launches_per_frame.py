"""launches_per_frame: kernel launch calls (``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel[Ex]``) and
``cudaMemcpyAsync`` calls in the profiled sub-window, over its frames:
every call there, under the system's ``submit`` and ``record`` and the
sink alike.  A count: it repeats exactly.  Layer: host dispatch."""

UNIT = "launches"


def read(run):
    if run.trace is None or run.trace.frames == 0:
        return None
    return run.trace.launch_calls / run.trace.frames
