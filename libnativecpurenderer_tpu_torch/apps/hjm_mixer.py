"""hjm_mixer: MIDI -> sample-overlay WAV (reference app parity).

Counterpart of ``libnativecpurenderer_tpu/apps/hjm_mixer.py``, a behaviour
mirror of the reference's ``src/hjm_mixer.py``: pair note_on/off per
(channel, note) with a 0.1 s default length (:26-51), build a silent
44.1 kHz stereo target sized to the last onset + 1 s (:63-67), take the
3x132 instrument banks ("ha", "ji", "mi" x notes 12-143, :70-77) from a
:class:`Bank`, round-robin the instrument per distinct onset time
(:79-87) and overlay additively: every (instrument, note) group in one
``overlay_groups`` call, on the target's device (``--device``, the card
by default), which adds the song's events in order from one segment
table: one kernel launch on the card.

:func:`mix` is the mix alone: song bytes and a bank in, the mixed
``AudioClip`` out, no file read or written.  A long-lived caller (the
web service) keeps one :class:`Bank` resident and hands it to every mix;
:func:`main`, the CLI, builds a bank for its one song.

Kept quirks: the bank list is indexed by the raw MIDI note ``n`` although
the files are named 12..143 (reference :88-93: note n plays file
``{n+12}.wav``); ``--dnote`` shifts before the min/max filter; the
reference's duplicate ``-o`` flag (:103/:107) is repaired by giving
``--offset`` its long name only.  A negative offset moves onsets before
the start, where the overlay follows JAX's ``mode="drop"``
(``ops/audio_ops.py``).

The SMF parse, the note pairing and the round-robin grouping
(:func:`note_groups`) are one call of the SMF core (``csrc/smf.c``, a
host extension built at the first mix), bit for bit with their Python
path (``models/midi.MidiFile``, :func:`collect_notes` and the grouping
loop), which runs where the core is not built or declines the song.

Span (``tracing``): ``lncr.hjm.notes`` around the SMF parse, the note
pairing and the round-robin grouping of :func:`mix`.  Counters, reset to
0 here: ``Bank.decodes``, the bank files decoded by every bank;
``note_groups.native`` / ``.python``, the songs each path of
:func:`note_groups` took.

    python -m libnativecpurenderer_tpu_torch.apps.hjm_mixer \\
        -r <bank dir> -i song.mid -o out.wav [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import typing
from collections import defaultdict

from .. import tracing
from ..audio import AudioClip
from ..interop import as_device
from ..models import midi
from ..ops import _kernels

DEFAULT_NOTELENGTH = 0.1
FRAME_RATE = 44100
CHANNELS = 2
BANK_NAMES = ("ha", "ji", "mi")
BANK_FILES = range(12, 144)     # each bank's files, {12..143}.wav


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


class Bank:
    """The instrument banks of the mix, resident on ``device``: clip
    ``(inst, n)`` is file ``BANK_NAMES[inst]/{n + 12}.wav`` under ``res``,
    decoded through ``AudioClip.from_file`` and resampled to
    ``sample_rate`` and ``channels`` once, at its first use, then kept
    for the bank's life: a later mix decodes, uploads and resamples
    nothing.  :meth:`preload` loads every file of the banks at once, as
    upstream's main does (:70-77)."""

    decodes = 0

    def __init__(self, res: str, sample_rate: int = FRAME_RATE,
                 channels: int = CHANNELS, device="cuda"):
        self.res = res
        self.sample_rate, self.channels = int(sample_rate), int(channels)
        self.device = as_device(device)
        self._clips: dict = {}

    def clip(self, inst: int, n: int) -> AudioClip:
        """Bank ``inst``'s clip at list position ``n``: file ``n + 12``."""
        key = (inst, n)
        got = self._clips.get(key)
        if got is None:
            got = self._clips[key] = self._load(inst, n)
        return got

    def _load(self, inst: int, n: int) -> AudioClip:
        clip = AudioClip.from_file(os.path.join(
            self.res, BANK_NAMES[inst], f"{n + 12}.wav"), device=self.device)
        Bank.decodes += 1
        clip.resample(self.sample_rate, self.channels)
        return clip

    def preload(self) -> "Bank":
        """Load every file of the banks now; returns the bank."""
        for inst in range(len(BANK_NAMES)):
            for f in BANK_FILES:
                self.clip(inst, f - 12)
        return self


def note_groups(midi_bytes: bytes, min_note: int, max_note: int,
                dnote: int = 0, offset: int = 0):
    """The song's notes (``collect_notes``) and its groups: onset seconds
    by (instrument, bank list position), the instrument round-robin per
    distinct onset (reference :79-87), the note shifted by ``dnote``
    before the min/max filter and the onset by ``offset`` ms.  One call
    of the SMF core where it is built and takes the song, else the
    Python path; ``.native`` and ``.python`` count the songs each took."""
    core = _kernels.host_core("smf")
    got = None if core is None else core.note_groups(
        midi_bytes, min_note, max_note, dnote, offset, DEFAULT_NOTELENGTH,
        len(BANK_NAMES))
    if got is None:
        note_groups.python += 1
        return _note_groups(midi_bytes, min_note, max_note, dnote, offset)
    note_groups.native += 1
    notes, groups = got
    if not notes:
        raise ValueError("no notes in MIDI file")
    return notes, defaultdict(list, groups)


note_groups.native = note_groups.python = 0


def _note_groups(midi_bytes: bytes, min_note: int, max_note: int,
                 dnote: int = 0, offset: int = 0):
    """:func:`note_groups`' Python path."""
    notes = collect_notes(midi.MidiFile(midi_bytes))
    if not notes:
        raise ValueError("no notes in MIDI file")
    groups: dict = defaultdict(list)
    curri = -1
    lastsec = -1e9
    for sec, _et, n in notes:
        n += dnote
        sec += offset / 1000
        if sec != lastsec:
            curri += 1
            lastsec = sec
        if n < min_note or n > max_note:
            continue
        curri = curri % len(BANK_NAMES)
        groups[(curri, n)].append(sec)
    return notes, groups


def mix(midi_bytes: bytes, bank: Bank, min_note: int, max_note: int,
        dnote: int = 0, offset: int = 0,
        base: typing.Optional[AudioClip] = None) -> AudioClip:
    """The song ``midi_bytes`` mixed from ``bank`` onto ``base``, in
    place, or onto a silent target in the bank's format on its device,
    sized to the last onset + 1 s; returns the mixed clip."""
    with tracing.span("lncr.hjm.notes"):
        notes, groups = note_groups(midi_bytes, min_note, max_note, dnote,
                                    offset)
    if base is None:
        max_time = notes[-1][0] + 1.0
        base = AudioClip.slient(bank.sample_rate, bank.channels,
                                int(bank.sample_rate * max_time),
                                device=bank.device)
    elif (base.sample_rate, base.channels) != (bank.sample_rate,
                                               bank.channels):
        raise ValueError("the base's format is not the bank's")
    base.overlay_groups([(bank.clip(inst, n), secs)
                         for (inst, n), secs in groups.items()])
    return base


def main(args: ProgInput) -> None:
    """Mix ``args.input`` onto a silent target (or ``args.base``) and
    write the WAV to ``args.output``.  The silent target is made on
    ``args.device`` (the card when the namespace has none); the bank
    decodes the clips the song plays on the host and moves them to the
    target's device."""
    with open(args.input, "rb") as f:
        data = f.read()
    base = args.base
    if base is None:
        bank = Bank(args.res, device=getattr(args, "device", "cuda"))
    else:
        bank = Bank(args.res, base.sample_rate, base.channels, base.device)
    out = mix(data, bank, args.min_note, args.max_note, args.dnote,
              args.offset, base)
    with open(args.output, "wb") as f:
        f.write(out.save_as_wav())


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
