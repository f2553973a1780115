"""The port's SMF core (``csrc/smf.c``, ``hjm_mixer.note_groups``' native
path) against the Python path it replaces (``models/midi.MidiFile``,
``collect_notes`` and the grouping loop), bit for bit: on the benchmark
cell's seeded songs and on crafted files that reach every branch of the
parse and the pairing, the notes and the groups must be equal in value,
float bits, type, key order and list order.  Where the core declines a
song (a truncated file, an SMPTE division, a chunk other than MTrk, a
header other than MThd) or cannot be loaded, the Python path gives its
result or raises its exception.  The notes also equal the JAX package's
``collect_notes`` on the cell's songs."""

import functools
import json
import os
import struct

import numpy as np
import pytest

from bench_torch.generators import midi_songs
from libnativecpurenderer_tpu_torch.apps import hjm_mixer
from libnativecpurenderer_tpu_torch.ops import _kernels

BENCH = os.path.join(os.path.dirname(__file__), "..", "bench_torch")
with open(os.path.join(BENCH, "configs", "hjm_mixer_song_1500.json")) as f:
    CONFIG = json.load(f)
with open(os.path.join(BENCH, "traffic", "midi_songs_1500.json")) as f:
    MIX = json.load(f)
CELL_REQUEST = (CONFIG["min_note"], CONFIG["max_note"], CONFIG["dnote"],
                CONFIG["offset"])
SHIFTED_REQUEST = (60, 100, -13, -250)
REQUESTS = {"cell": CELL_REQUEST, "shifted": SHIFTED_REQUEST}
SEEDS = (8800000001, 2 ** 40 + 77)

needs_core = pytest.mark.skipif(
    _kernels.host_core("smf") is None,
    reason=f"the SMF core cannot be built here: "
           f"{_kernels.core_errors.get('smf')}")


@functools.cache
def cell_songs(seed):
    return midi_songs.Generator(MIX, CONFIG, seed).songs


# -- crafted files --------------------------------------------------------

def tempo(uspq):
    return b"\xFF\x51\x03" + uspq.to_bytes(3, "big")


def track(events, end=True):
    """An MTrk chunk of (delta, bytes) events, closed by end of track."""
    body = b"".join(midi_songs.vlq(d) + e for d, e in events)
    if end:
        body += b"\x00\xFF\x2F\x00"
    return b"MTrk" + struct.pack(">I", len(body)) + body


def smf(*chunks, fmt=1, division=480, ntrks=None):
    ntrks = len(chunks) if ntrks is None else ntrks
    return (b"MThd" + struct.pack(">IHHH", 6, fmt, ntrks, division)
            + b"".join(chunks))


def on(ch, note, vel=100):
    return bytes([0x90 | ch, note, vel])


def off(ch, note, vel=0):
    return bytes([0x80 | ch, note, vel])


CRAFTED = {
    # tempos only in the second track, none at tick 0
    "format1_tempos_in_later_track": smf(
        track([(0, on(0, 60)), (240, off(0, 60)), (120, on(1, 64)),
               (600, off(1, 64)), (0, on(0, 72)), (960, off(0, 72)),
               (30, on(2, 48)), (500, off(2, 48))]),
        track([(300, tempo(400000)), (600, tempo(650000)),
               (400, tempo(350000))])),
    # two tempos at one tick (ties taken by uspq), a third in another track
    "two_tempos_at_one_tick": smf(
        track([(0, tempo(500000)), (480, tempo(400000)), (0, tempo(300000)),
               (0, on(0, 60)), (100, off(0, 60)), (380, on(0, 62)),
               (200, off(0, 62))]),
        track([(480, tempo(600000)), (1, on(1, 67)), (700, off(1, 67))])),
    # running status after a note_on, a note_on of velocity 0 as note_off
    "running_status_and_velocity_0": smf(track([
        (0, on(3, 60)), (0, bytes([64, 90])), (0, bytes([67, 80])),
        (240, bytes([60, 0])), (0, bytes([64, 0])), (120, bytes([67, 0])),
        (10, off(3, 70)), (0, bytes([71, 40])),
        (60, on(3, 72, 0)), (0, bytes([74, 55])), (400, bytes([74, 0]))])),
    # a repeated note_on closes the pending one at + DEFAULT_NOTELENGTH
    "repeated_note_on": smf(track([
        (0, on(0, 60)), (100, on(0, 60)), (100, on(0, 60)),
        (300, off(0, 60)), (0, on(1, 60)), (0, on(1, 60)),
        (50, off(1, 60))])),
    # a note_off with nothing pending is skipped
    "unmatched_note_off": smf(track([
        (0, off(0, 60)), (10, on(0, 62)), (100, off(0, 62)),
        (0, off(0, 62)), (5, off(5, 99)), (20, on(0, 64)),
        (200, off(0, 64))])),
    # notes left pending at the end, in the dict's insertion order: a key
    # popped and inserted again moves to the end; ties of onset keep it
    "pending_at_end": smf(track([
        (0, on(1, 70)), (0, on(0, 50)), (0, on(2, 55)), (0, on(1, 70)),
        (120, on(0, 52)), (0, on(4, 40)), (0, off(0, 50)),
        (300, on(0, 52))])),
    # notes paired across tracks: keyed by (channel, note) over the file
    "pairing_across_tracks": smf(
        track([(0, on(0, 60)), (10, on(1, 61)), (480, on(2, 62))]),
        track([(240, off(0, 60)), (500, off(2, 62)), (0, on(0, 60))]),
        track([(100, off(1, 61)), (900, off(0, 60))])),
    # sysex F0 and F7, a text meta, and events after 0x2F, which are read
    # by nothing
    "sysex_and_meta_after_end": smf(track([
        (0, b"\xF0\x05\x7E\x7F\x09\x01\xF7"), (0, on(0, 60)),
        (10, b"\xF7\x02\x01\x02"), (0, b"\xFF\x01\x04text"),
        (200, off(0, 60)), (5, on(0, 65)), (300, off(0, 65)),
        (0, b"\xFF\x2F\x00"), (0, on(0, 90)), (10, off(0, 90)),
        (0, b"\xFF\x51\x03\x01\x00\x00")], end=False)),
    # A0, B0, C0, D0 and E0 events (two data bytes for A0/B0/E0, one for
    # C0/D0), some in running status, between notes
    "channel_events": smf(track([
        (0, b"\xC0\x05"), (0, b"\x06"), (0, on(0, 60)),
        (10, b"\xA0\x3C\x40"), (0, b"\x3D\x41"), (10, b"\xB0\x07\x64"),
        (0, b"\x0A\x20"), (10, b"\xD0\x30"), (0, b"\x31"),
        (10, b"\xE0\x00\x40"), (0, b"\x10\x50"), (100, off(0, 60)),
        (0, b"\xC1\x10"), (0, on(1, 66)), (50, b"\xD1\x22"),
        (50, off(1, 66))])),
    # chords: equal onsets across channels (one round-robin step each),
    # notes the shifted request filters out among them
    "chord_across_channels": smf(track([
        (0, on(0, 60)), (0, on(1, 64)), (0, on(2, 67)), (0, on(3, 40)),
        (200, off(0, 60)), (0, off(1, 64)), (0, off(2, 67)),
        (0, off(3, 40)), (0, on(0, 110)), (0, on(1, 72)), (0, on(2, 61)),
        (100, on(3, 60)), (0, on(2, 60)), (150, off(0, 110)),
        (0, off(1, 72)), (0, off(2, 61)), (0, off(3, 60)),
        (0, off(2, 60))])),
}


# -- the two paths ------------------------------------------------------

def python_path(monkeypatch, data, request_):
    """``note_groups`` with no core loaded: the fallback, as run where the
    core cannot be built."""
    with monkeypatch.context() as mp:
        mp.setattr(_kernels, "host_core", lambda name: None)
        return outcome(data, request_)


def outcome(data, request_):
    """``note_groups``' result, or the type of what it raised, and the
    songs each path counted."""
    fn = hjm_mixer.note_groups
    n0, p0 = fn.native, fn.python
    try:
        got = fn(data, *request_)
    except Exception as exc:            # noqa: BLE001 - compared by type
        got = type(exc)
    return got, (fn.native - n0, fn.python - p0)


def bits(values):
    return np.asarray(values, np.float64).view(np.int64).tolist()


def assert_same(got, want):
    """Equal notes and groups: types, float bits, key and list order."""
    if isinstance(want, type):
        assert got is want
        return
    gnotes, ggroups = got
    wnotes, wgroups = want
    assert type(gnotes) is type(wnotes) is list
    assert len(gnotes) == len(wnotes)
    assert [tuple(map(type, t)) for t in gnotes] == \
        [tuple(map(type, t)) for t in wnotes]
    assert [t[2] for t in gnotes] == [t[2] for t in wnotes]
    for k in (0, 1):
        assert bits([t[k] for t in gnotes]) == bits([t[k] for t in wnotes])
    assert type(ggroups) is type(wgroups)
    assert list(ggroups) == list(wgroups)
    assert [tuple(map(type, k)) for k in ggroups] == \
        [tuple(map(type, k)) for k in wgroups]
    for key in wgroups:
        assert type(ggroups[key]) is list
        assert all(type(v) is float for v in ggroups[key])
        assert bits(ggroups[key]) == bits(wgroups[key])


CASES = ([pytest.param("cell", seed, k, r, id=f"cell-{seed}-song{k}-{r}")
          for seed in SEEDS for k in range(MIX["period"]) for r in REQUESTS]
         + [pytest.param("crafted", None, name, r, id=f"{name}-{r}")
            for name in CRAFTED for r in REQUESTS])


@needs_core
@pytest.mark.parametrize("kind, seed, song, req", CASES)
def test_native_equals_python_path(monkeypatch, kind, seed, song, req):
    data = (cell_songs(seed)[song]["smf"] if kind == "cell"
            else CRAFTED[song])
    got, counts = outcome(data, REQUESTS[req])
    assert counts == (1, 0)
    want, want_counts = python_path(monkeypatch, data, REQUESTS[req])
    assert want_counts == (0, 1)
    assert not isinstance(want, type)
    assert_same(got, want)


def test_crafted_cases_reach_their_branches():
    """The crafted files hold what their names say, read by the Python
    path: tempos only in a later track, a tie of tempo ticks, a note left
    pending, notes after an end of track that are read by nothing."""
    from libnativecpurenderer_tpu_torch.models import midi
    mid = midi.MidiFile(CRAFTED["format1_tempos_in_later_track"])
    assert mid.format == 1 and len(mid.tracks) == 2
    notes = hjm_mixer.collect_notes(mid)
    assert len(notes) == 4
    assert hjm_mixer.collect_notes(midi.MidiFile(
        CRAFTED["sysex_and_meta_after_end"]))[-1][2] == 65
    pend = hjm_mixer.collect_notes(midi.MidiFile(CRAFTED["pending_at_end"]))
    assert [n for ont, _, n in pend if ont == 0.0] == [70, 50, 55, 70]


# -- declines and the fallback ------------------------------------------

def truncated():
    data = cell_songs(SEEDS[0])[0]["smf"]
    return data[:len(data) // 2]


DECLINED = {
    "truncated": truncated,
    "smpte_division": lambda: smf(
        track([(0, on(0, 60)), (40, off(0, 60)), (10, on(1, 62)),
               (80, off(1, 62))]), division=0xE728),
    "chunk_other_than_mtrk": lambda: smf(
        b"XFIH" + struct.pack(">I", 3) + b"abc",
        track([(0, on(0, 60)), (100, off(0, 60))]), ntrks=1),
    "header_other_than_mthd": lambda: b"RIFF" + smf(
        track([(0, on(0, 60)), (100, off(0, 60))]))[4:],
}


@needs_core
@pytest.mark.parametrize("name", list(DECLINED))
def test_declined_song_takes_the_python_path(monkeypatch, name):
    data = DECLINED[name]()
    core = _kernels.host_core("smf")
    assert core.note_groups(data, *CELL_REQUEST, hjm_mixer.DEFAULT_NOTELENGTH,
                            len(hjm_mixer.BANK_NAMES)) is None
    got, counts = outcome(data, CELL_REQUEST)
    assert counts == (0, 1)
    want, _ = python_path(monkeypatch, data, CELL_REQUEST)
    assert_same(got, want)


def test_unloadable_core_falls_back(monkeypatch):
    """With the core's build failing, ``note_groups`` gives the Python
    path's values and ``core_errors`` says why."""
    data = cell_songs(SEEDS[0])[3]["smf"]
    want = hjm_mixer._note_groups(data, *CELL_REQUEST)

    def no_compiler(name):
        raise RuntimeError("no C compiler (gcc or cc) found")
    monkeypatch.setattr(_kernels, "build", no_compiler)
    monkeypatch.setattr(_kernels, "core_errors", {})
    monkeypatch.setattr(_kernels, "host_core",
                        functools.cache(_kernels.host_core.__wrapped__))
    got, counts = outcome(data, CELL_REQUEST)
    assert counts == (0, 1)
    assert "no C compiler" in _kernels.core_errors["smf"]
    assert_same(got, want)


@needs_core
def test_a_song_counts_native_once():
    got, counts = outcome(cell_songs(SEEDS[1])[5]["smf"], SHIFTED_REQUEST)
    assert counts == (1, 0)
    assert not isinstance(got, type)


@needs_core
def test_mix_takes_the_native_path_on_the_cell_songs(monkeypatch):
    """``mix`` reads its notes through ``note_groups``: one native song a
    mix and no Python one (the bank's clips stubbed: only the notes are
    looked at here)."""
    seen = []

    class Target:
        def overlay_groups(self, pairs):
            seen.append(len(pairs))

    class Bank:
        sample_rate, channels, device = 44100, 2, "cpu"

        def clip(self, inst, n):
            return None

    monkeypatch.setattr(hjm_mixer.AudioClip, "slient",
                        staticmethod(lambda *a, **kw: Target()))
    fn = hjm_mixer.note_groups
    n0, p0 = fn.native, fn.python
    for s in cell_songs(SEEDS[0]):
        hjm_mixer.mix(s["smf"], Bank(), *CELL_REQUEST)
    assert (fn.native - n0, fn.python - p0) == (MIX["period"], 0)
    assert len(seen) == MIX["period"] and min(seen) > 100


def test_no_notes_raises_on_both_paths(monkeypatch):
    data = smf(track([(0, tempo(400000)), (10, b"\xC0\x01")]))
    got, _ = outcome(data, CELL_REQUEST)
    want, _ = python_path(monkeypatch, data, CELL_REQUEST)
    assert got is want is ValueError


# -- against the JAX package ---------------------------------------------

@needs_core
@pytest.mark.parametrize("song", range(MIX["period"]))
def test_notes_equal_jax_collect_notes(song):
    from libnativecpurenderer_tpu.apps import hjm_mixer as jax_mixer
    from libnativecpurenderer_tpu.models import midi as jax_midi
    data = cell_songs(SEEDS[0])[song]["smf"]
    notes, _ = hjm_mixer.note_groups(data, *CELL_REQUEST)
    want = jax_mixer.collect_notes(jax_midi.MidiFile(data))
    assert notes == want
    assert bits([t[0] for t in notes]) == bits([t[0] for t in want])
    assert bits([t[1] for t in notes]) == bits([t[1] for t in want])
