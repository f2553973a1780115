"""The least work of a mix of the audio engine, counted from its inputs:
the base clip read once, the mixed clip written once (``overlay_many``
leaves the mix in the clip), the sound read once and the int16 PCM
written once; one operation for each row and channel of an event that
falls inside the clip (its add), four for each quantised sample (two
clamps, the scale and the conversion).

Nothing comes from the program: not its route, its FFT length or its
buffers, so whatever implements the mix keeps the same yardstick.
"""

from ..references.audio_mix import start_frames

QUANTISE_OPS = 4
PCM_BYTES = 2                # int16


def event_rows(offsets_s, rate: int, rows: int, sound_rows: int) -> int:
    """The sound's rows that land inside a clip of ``rows`` rows, summed
    over the events at ``offsets_s`` (an event at or past the end adds
    none, one just before it is cut short)."""
    st = start_frames(offsets_s, rate)
    return int(((st + sound_rows).clip(0, rows) - st.clip(0, rows)).sum())


def work(c: dict) -> tuple:
    """(bytes, operations) of the mixes counted in ``c`` (the audio
    system's ``work``)."""
    samples = c["rows"] * c["channels"]
    n_bytes = c["mixes"] * (2 * samples * c["sample_bytes"]
                            + c["sound_rows"] * c["channels"]
                            * c["sample_bytes"] + samples * PCM_BYTES)
    n_ops = (c["event_rows"] * c["channels"]
             + c["mixes"] * samples * QUANTISE_OPS)
    return n_bytes, n_ops
