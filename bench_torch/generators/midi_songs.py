"""``midi_songs``: mix k's input is song ``k mod period`` of a period of
seeded songs made at construction, so a frame costs the timed loop
nothing.  Each song is a format-0 SMF after the mixer's stand-in song
(``chip_smoke.seeded_song``): ``notes`` notes on ``channels`` channels,
notes ``note_lo``-``note_hi``, velocities ``velocity``, no gap before a
``chord_share`` of the onsets (a chord) and a gap of ``gap_ticks`` ticks
before the others, lengths of ``length_ticks`` ticks, a program change a
channel, and the tempo (us a quarter) of ``tempos``: ``[note, tempo]``
pairs, each from that note's onset on.

A song's input is a dict of the file's bytes (``smf``) and three tuples
in the song's order: each note's onset tick (``ticks``), its exact onset
in seconds (``onsets_s``, a ``Fraction``, over the tempo map) and its
note number (``notes``).

The onset rule: an onset whose exact position in frames of
``config["sample_rate"]`` lies within ``MARGIN`` of a whole number moves
one tick later, until it does not.  At 500,000 us a quarter and 480
ticks a tick is 735/16 frames, so one tick in 16 lands on a whole frame,
where float64 seconds would truncate to either side; the rule keeps a
parse in float64 and the exact onsets on the same start frame."""

from __future__ import annotations

from fractions import Fraction

import numpy as np

SALT = 9
MARGIN = Fraction(1, 64)


def vlq(v: int) -> bytes:
    """A MIDI variable-length quantity."""
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


def song(mix: dict, rate: int, rng: np.random.Generator) -> dict:
    """One seeded song of ``mix`` (see the module's docstring).  A
    position in frames is held as the whole number ``P`` over ``Q`` =
    10^6 x the division: the sum of ticks x tempo x rate."""
    division = int(mix["division"])
    n, channels = int(mix["notes"]), int(mix["channels"])
    tempos = {int(k): int(u) for k, u in mix["tempos"]}
    if 0 not in tempos:
        raise ValueError("the tempo map needs a tempo from note 0")
    q = 10 ** 6 * division
    margin = q * MARGIN.numerator // MARGIN.denominator

    def tempo_event(uspq):
        return bytes([0xFF, 0x51, 0x03]) + uspq.to_bytes(3, "big")

    programs = rng.integers(0, 128, channels)
    chord = rng.random(n) < mix["chord_share"]
    gaps = rng.integers(mix["gap_ticks"][0], mix["gap_ticks"][1] + 1, n)
    chans = rng.integers(0, channels, n)
    notes = rng.integers(mix["note_lo"], mix["note_hi"] + 1, n)
    vels = rng.integers(mix["velocity"][0], mix["velocity"][1] + 1, n)
    lengths = rng.integers(mix["length_ticks"][0],
                           mix["length_ticks"][1] + 1, n)
    ev = [(0, tempo_event(tempos[0]))]
    ev += [(0, bytes([0xC0 | c, int(programs[c])])) for c in range(channels)]
    seg_tick, seg_p, step = 0, 0, tempos[0] * rate
    tick = p = 0
    ticks, onsets = [], []
    for k in range(n):
        if k == 0 or not chord[k]:
            tick += 0 if k == 0 else int(gaps[k])
            while True:
                p = seg_p + (tick - seg_tick) * step
                r = p % q
                if margin <= r <= q - margin:
                    break
                tick += 1
        if k > 0 and k in tempos:
            seg_tick, seg_p, step = tick, p, tempos[k] * rate
            ev.append((tick, tempo_event(tempos[k])))
        c, note = int(chans[k]), int(notes[k])
        ev.append((tick, bytes([0x90 | c, note, int(vels[k])])))
        ev.append((tick + int(lengths[k]), bytes([0x80 | c, note, 0])))
        ticks.append(tick)
        onsets.append(Fraction(p, q * rate))
    ev.sort(key=lambda e: e[0])
    track, last = [], 0
    for t, data in ev:
        track.append(vlq(t - last) + data)
        last = t
    track.append(b"\x00\xFF\x2F\x00")
    body = b"".join(track)
    smf = (b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big")
           + (1).to_bytes(2, "big") + division.to_bytes(2, "big")
           + b"MTrk" + len(body).to_bytes(4, "big") + body)
    return {"smf": smf, "ticks": tuple(ticks), "onsets_s": tuple(onsets),
            "notes": tuple(int(v) for v in notes)}


class Generator:
    def __init__(self, mix: dict, config: dict, seed: int):
        self.seed = seed % (1 << 64)
        self.period = int(mix["period"])
        rate = int(config["sample_rate"])
        self.songs = [song(mix, rate, np.random.default_rng(
            [self.seed, SALT, k])) for k in range(self.period)]

    def frame(self, k: int) -> dict:
        return self.songs[k % self.period]
