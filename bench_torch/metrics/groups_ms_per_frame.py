"""groups_ms_per_frame: host milliseconds a mix in the port's span
``lncr.audio.overlay_groups`` (``AudioClip.overlay_groups``: the cohort
sort and the scatter route's slice adds enqueued, one an event run),
over the traced run's replay of the profiled mixes (the mixer system's
``work``), with tracing on.  Layer: audio scatter
routes."""

UNIT = "ms"
SPAN = "lncr.audio.overlay_groups"


def read(run):
    replay = run.work.get("audio_replay")
    if not replay or SPAN not in replay["spans"]:
        return None
    return replay["spans"][SPAN]["ns"] / replay["mixes"] / 1e6
