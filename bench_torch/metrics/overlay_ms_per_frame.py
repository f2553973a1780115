"""overlay_ms_per_frame: host milliseconds a mix in the port's span
``lncr.audio.overlay_many`` (``AudioClip.overlay_many``: the starts, the
route and, on the FFT route, its launches enqueued), over the traced
run's replay of the profiled mixes (the audio system's ``work``), with
tracing on.  Layer: audio engine."""

UNIT = "ms"
SPAN = "lncr.audio.overlay_many"


def read(run):
    replay = run.work.get("audio_replay")
    if not replay or SPAN not in replay["spans"]:
        return None
    return replay["spans"][SPAN]["ns"] / replay["mixes"] / 1e6
