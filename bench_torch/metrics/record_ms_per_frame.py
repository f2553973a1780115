"""record_ms_per_frame: host milliseconds a frame of the benchmark's own
span around its draw calls on the recording proxy (and the snapshot of
its command list), over the window's frames.  Layer: chart record."""

UNIT = "ms"


def read(run):
    ns = run.spans.ns.get("record")
    if not ns:
        return None
    return ns / run.spans.calls["record"] / 1e6
