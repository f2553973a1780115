"""The least work of a mix of the MIDI mixer, counted from its inputs,
each read once and each output written once: the silent target written
once (its fill) and read once by the quantise, the int16 PCM written
once, and each distinct bank clip that the mix plays read once, as far
as some event of it lands inside the target.  One operation for each
row and channel of an event inside the target (its add), four for each
quantised sample (two clamps, the scale and the conversion).  The bank
is resident, so its decode and resample are no part of a mix.

Nothing comes from the program: not its routes, its cohorts or its
buffers, so whatever implements the mix keeps the same yardstick.
"""

QUANTISE_OPS = 4
PCM_BYTES = 2                # int16


def event_rows(starts, rows: int, clip_rows: int) -> int:
    """The clip rows that land inside a target of ``rows`` rows, summed
    over events at the start frames ``starts``."""
    return sum(max(0, min(s + clip_rows, rows) - max(s, 0)) for s in starts)


def clip_rows_read(starts, rows: int, clip_rows: int) -> int:
    """The rows of one clip that some event at the start frames
    ``starts`` lands inside a target of ``rows`` rows: the union of
    their source ranges, each counted once."""
    spans = sorted((max(0, -s), min(clip_rows, rows - s)) for s in starts)
    n, end = 0, 0
    for lo, hi in spans:
        lo = max(lo, end)
        if hi > lo:
            n += hi - lo
            end = hi
    return n


def work(c: dict) -> tuple:
    """(bytes, operations) of the mixes counted in ``c`` (the mixer
    system's ``work``): ``samples``, the target's samples summed over
    the mixes; ``clip_samples``, the distinct clips' rows read
    (``clip_rows_read``) x channels, summed; ``event_samples``, the
    event rows x channels summed; ``sample_bytes``, a float sample's
    bytes."""
    sb = c["sample_bytes"]
    n_bytes = (c["samples"] * (2 * sb + PCM_BYTES)
               + c["clip_samples"] * sb)
    n_ops = c["event_samples"] + c["samples"] * QUANTISE_OPS
    return n_bytes, n_ops
