"""wav_ms_per_frame: host milliseconds a mix in the port's span
``lncr.audio.save_as_wav`` (the int16 quantise, the pinned copy and the
wait on it, which holds the device's mix, and the RIFF bytes), over the
traced run's replay of the profiled mixes (the audio system's
``work``), with tracing on.  Layer: audio engine."""

UNIT = "ms"
SPAN = "lncr.audio.save_as_wav"


def read(run):
    replay = run.work.get("audio_replay")
    if not replay or SPAN not in replay["spans"]:
        return None
    return replay["spans"][SPAN]["ns"] / replay["mixes"] / 1e6
