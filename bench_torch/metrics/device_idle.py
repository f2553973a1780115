"""device_idle: the share of the profiled sub-window in which no kernel,
copy or fill ran on the card (one minus the union of their intervals
over the window's length).  A copy counts as busy.  Layer: device."""

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
