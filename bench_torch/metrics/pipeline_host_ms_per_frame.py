"""pipeline_host_ms_per_frame: host milliseconds a frame in the
benchmark's calls to the system's ``submit`` (the port's frame pipeline
or mixer), less the time the sink's own callbacks took inside them, over
the window's frames.  Layer: system submit."""

UNIT = "ms"


def read(run):
    ns = run.spans.ns.get("pipeline")
    if not ns:
        return None
    return ns / run.spans.calls["pipeline"] / 1e6
