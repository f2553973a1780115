"""notes_ms_per_frame: host milliseconds a mix in the port's span
``lncr.hjm.notes`` (``apps/hjm_mixer.mix``: the SMF parse, the note
pairing and the round-robin grouping), over the traced run's replay of
the profiled mixes (the mixer system's ``work``), with tracing on.
Layer: MIDI mixer."""

UNIT = "ms"
SPAN = "lncr.hjm.notes"


def read(run):
    replay = run.work.get("audio_replay")
    if not replay or SPAN not in replay["spans"]:
        return None
    return replay["spans"][SPAN]["ns"] / replay["mixes"] / 1e6
