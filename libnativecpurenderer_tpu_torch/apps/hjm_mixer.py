"""hjm_mixer: MIDI -> sample-overlay WAV (reference app parity).

Counterpart of ``libnativecpurenderer_tpu/apps/hjm_mixer.py``, a behaviour
mirror of the reference's ``src/hjm_mixer.py``: pair note_on/off per
(channel, note) with a 0.1 s default length (:26-51), build a silent
44.1 kHz stereo target sized to the last onset + 1 s (:63-67), load the
3x132 instrument banks ("ha", "ji", "mi" x notes 12-143, :70-77) lazily,
round-robin the instrument per distinct onset time (:79-87) and overlay
additively: every (instrument, note) group in one ``overlay_groups`` call,
on the target's device (``--device``, the card by default).

Kept quirks: the bank list is indexed by the raw MIDI note ``n`` although
the files are named 12..143 (reference :88-93: note n plays file
``{n+12}.wav``); ``--dnote`` shifts before the min/max filter; the
reference's duplicate ``-o`` flag (:103/:107) is repaired by giving
``--offset`` its long name only.  A negative offset moves onsets before
the start, where the overlay follows JAX's ``mode="drop"``
(``ops/audio_ops.py``).

    python -m libnativecpurenderer_tpu_torch.apps.hjm_mixer \\
        -r <bank dir> -i song.mid -o out.wav [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import typing
from collections import defaultdict

from ..audio import AudioClip
from ..models import midi

DEFAULT_NOTELENGTH = 0.1
FRAME_RATE = 44100
CHANNELS = 2
BANK_NAMES = ("ha", "ji", "mi")


class ProgInput(typing.Protocol):
    res: str
    input: str
    output: str
    min_note: int
    max_note: int
    dnote: int
    base: typing.Optional[AudioClip]
    offset: int
    device: str


def collect_notes(mid: midi.MidiFile):
    """Pair note_on/off per (channel, note); unmatched note_ons get the
    default length (reference MidiNoteBin, :28-51)."""
    pending: dict = {}
    result = []
    for track in mid.tracks:
        for msg in track:
            if msg["type"] not in ("note_on", "note_off"):
                continue
            key = (msg["channel"], msg["note"])
            if msg["type"] == "note_on":
                if key in pending:
                    ont, note = pending.pop(key)
                    result.append((ont, ont + DEFAULT_NOTELENGTH, note))
                pending[key] = (msg["sec_time"], msg["note"])
            elif msg["type"] == "note_off":
                if key not in pending:
                    continue
                ont, note = pending.pop(key)
                result.append((ont, msg["sec_time"], note))
    for ont, note in pending.values():
        result.append((ont, ont + DEFAULT_NOTELENGTH, note))
    result.sort(key=lambda x: x[0])
    return result


def main(args: ProgInput) -> None:
    """Mix ``args.input`` onto a silent target (or ``args.base``) and
    write the WAV to ``args.output``.  The silent target is made on
    ``args.device`` (the card when the namespace has none); the bank clips
    are decoded on the host and moved to the target's device."""
    with open(args.input, "rb") as f:
        mid = midi.MidiFile(f.read())

    notes = collect_notes(mid)
    if not notes:
        raise ValueError("no notes in MIDI file")

    max_time = notes[-1][0] + 1.0
    bgm = (AudioClip.slient(FRAME_RATE, CHANNELS, int(FRAME_RATE * max_time),
                            device=getattr(args, "device", "cuda"))
           if args.base is None else args.base)

    # the banks' clips, each decoded and resampled the first time a note
    # plays it; bank list position n holds file (n+12).wav
    bank_cache: dict = {}

    def bank_clip(inst: int, n: int) -> AudioClip:
        key = (inst, n)
        if key not in bank_cache:
            clip = AudioClip.from_file(os.path.join(
                args.res, BANK_NAMES[inst], f"{n + 12}.wav"),
                device=bgm.device)
            clip.resample_like(bgm)
            bank_cache[key] = clip
        return bank_cache[key]

    # round-robin instrument per distinct onset (reference :79-87), then
    # one group of onsets per (instrument, note)
    groups: dict = defaultdict(list)
    curri = -1
    lastsec = -1e9
    for sec, _et, n in notes:
        n += args.dnote
        sec += args.offset / 1000
        if sec != lastsec:
            curri += 1
            lastsec = sec
        if n < args.min_note or n > args.max_note:
            continue
        curri = curri % len(BANK_NAMES)
        groups[(curri, n)].append(sec)

    bgm.overlay_groups([(bank_clip(inst, n), secs)
                        for (inst, n), secs in groups.items()])

    with open(args.output, "wb") as f:
        f.write(bgm.save_as_wav())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hjm_mixer")
    p.add_argument("-r", "--res", type=str, help="res file", required=True)
    p.add_argument("-i", "--input", help="input midi file", required=True)
    p.add_argument("-o", "--output", help="output wav file", required=True)
    p.add_argument("-min", "--min-note", help="min note", type=int,
                   default=60)
    p.add_argument("-max", "--max-note", help="max note", type=int,
                   default=127)
    p.add_argument("-d", "--dnote", help="dnote", type=int, default=0)
    p.add_argument("--offset", help="offset (ms)", type=int, default=0)
    p.add_argument("--device", help="torch device of the mix",
                   default="cuda")
    return p


if __name__ == "__main__":
    args = build_parser().parse_args()
    args.base = None
    main(args)
