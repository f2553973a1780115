"""frames_per_s: frames a second delivered to the sink in the window
(host clock).  A frame is the unit a system delivers: a u8 video frame,
or one mixed clip for a mixer, whose rate is mixes a second.  A system
delivers a batch at once, so the rate is taken from batch to batch: the
frames of the whole batches that arrived after the window's first whole
batch, over the time from that batch's last arrival to the last whole
batch's; a count of the frames in the window would swing by a batch
with where its edges fall between deliveries.  With fewer than two whole
batches in the window: the frames that arrived, over the window's
length."""

UNIT = "frames/s"


def read(run):
    if run.frames_in_window == 0:
        return None
    ends = run.arrivals[run.batch - 1::run.batch]
    if len(ends) < 2 or ends[-1] <= ends[0]:
        return run.frames_in_window / run.window_s
    return (len(ends) - 1) * run.batch / ((ends[-1] - ends[0]) / 1e9)
