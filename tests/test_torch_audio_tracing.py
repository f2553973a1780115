"""The audio engine's spans and counters on the CPU: the five
``lncr.audio.*`` spans with their call counts and nesting, the FFT
route's counter against the scatter route at the bucketed threshold, the
events that survive the drop, the PCM bytes written, WAV bytes equal with
tracing on and off, and nothing recorded with tracing off.  Then the
MIDI mixer's: ``lncr.hjm.notes`` and ``lncr.audio.overlay_groups`` called
once a mix and nested under an open span, ``overlay_groups``' counters
of groups, surviving events and slice adds (an event that wraps makes
two, one that is dropped none), the bank's decodes, and the same WAV
bytes and no record with tracing off."""

import numpy as np
import pytest
import torch

import libnativecpurenderer_tpu_torch as P
from bench_torch.generators import midi_songs
from bench_torch.systems import hjm_mix as hjm_system
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch import tracing
from libnativecpurenderer_tpu_torch.apps import hjm_mixer
from libnativecpurenderer_tpu_torch.ops import audio_ops

torch.set_num_threads(1)

RATE = 44100
SPANS = ("lncr.audio.overlay_many", "lncr.audio.fft",
         "lncr.audio.save_as_wav", "lncr.audio.copy_out",
         "lncr.audio.assemble")


@pytest.fixture(autouse=True)
def tracer_off_f32():
    """Each test starts and ends with tracing off and no spans, in the
    port's float32 default."""
    prev = pconfig.default_dtype()
    pconfig.set_default_dtype(torch.float32)
    tracing.enable(False)
    tracing.ranges(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()
    pconfig.set_default_dtype(prev)


def clip(rows, seed, gain):
    rng = np.random.default_rng(seed)
    return P.AudioClip._from_array(
        RATE, 2, rng.standard_normal((rows, 2)) * gain, device="cpu")


def counters():
    return (audio_ops.overlay_many.fft, audio_ops.overlay_many.events,
            P.AudioClip.save_as_wav.bytes)


def mixdown(rows=3 * RATE, sound_rows=RATE // 2, starts=None):
    """One mix through the public path: 64 events of a 0.5 s sound (the
    FFT route) onto a 3 s clip, or the given start frames; the WAV's
    bytes."""
    if starts is None:
        starts = np.random.default_rng(3).integers(0, rows, 64)
    target = clip(rows, 1, 0.05)
    target.overlay_many(clip(sound_rows, 2, 0.1), np.asarray(starts) / RATE)
    return target.save_as_wav()


def test_spans_counts_and_nesting():
    tracing.enable(True)
    wav = mixdown()
    tracing.enable(False)
    totals = tracing.totals()
    assert set(totals) == set(SPANS)
    assert all(totals[s]["calls"] == 1 for s in SPANS)
    parent = {r.name: r.parent.name if r.parent else None
              for r in tracing.records()}
    assert parent == {"lncr.audio.overlay_many": None,
                      "lncr.audio.fft": "lncr.audio.overlay_many",
                      "lncr.audio.save_as_wav": None,
                      "lncr.audio.copy_out": "lncr.audio.save_as_wav",
                      "lncr.audio.assemble": "lncr.audio.save_as_wav"}
    wrap = totals["lncr.audio.save_as_wav"]
    assert wrap["ns"] >= (totals["lncr.audio.copy_out"]["ns"]
                          + totals["lncr.audio.assemble"]["ns"])
    assert len(wav) > 3 * RATE * 4


@pytest.mark.parametrize("sound_rows,fft", [(65_536, 0), (65_537, 1)])
def test_fft_counter_by_route(sound_rows, fft):
    # 13 events pad to a bucket of 16: 16 x 65,536 == 2**20 takes the
    # scatter route, one more source row the FFT route
    starts = np.random.default_rng(26).integers(0, 140_000, 13)
    before = counters()
    tracing.enable(True)
    mixdown(rows=150_000, sound_rows=sound_rows, starts=starts)
    tracing.enable(False)
    assert counters()[0] - before[0] == fft
    assert tracing.totals().get("lncr.audio.fft", {"calls": 0})["calls"] \
        == fft
    assert tracing.totals()["lncr.audio.overlay_many"]["calls"] == 1


@pytest.mark.parametrize("sound_rows", [65_536, 65_537],
                         ids=["scatter", "fft"])
def test_events_count_the_survivors(sound_rows):
    rows = 150_000
    starts = np.array([0, 5, 77_000, 149_999, 150_000, 160_000, 140_000,
                       1_000_000, 12, 90_000, 150_001, 3, 149_000])
    survive = int((starts < rows).sum())
    before = counters()
    mixdown(rows=rows, sound_rows=sound_rows, starts=starts)
    after = counters()
    assert after[1] - before[1] == survive == 9
    assert after[2] - before[2] == rows * 2 * 2


def test_wav_bytes_equal_with_tracing_off_and_on():
    off = mixdown()
    tracing.enable(True)
    on = mixdown()
    tracing.enable(False)
    assert on == off
    assert tracing.totals()


def test_tracing_off_records_nothing():
    before = counters()
    mixdown()
    assert tracing.records() == [] and tracing.totals() == {}
    # the counters count whether tracing is on or off
    assert counters()[0] == before[0] + 1


# --------------------------------------------------------------------------
# the MIDI mixer
# --------------------------------------------------------------------------

SONG_MIX = {"notes": 40, "channels": 3, "note_lo": 50, "note_hi": 70,
            "velocity": [40, 127], "chord_share": 0.25,
            "gap_ticks": [30, 90], "length_ticks": [60, 400],
            "division": 480, "tempos": [[0, 500000], [20, 420000]]}


@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory):
    """Seeded banks of 0.05 s tones, every file of ha/ji/mi."""
    config = {"bank_rate": 48000, "bank_seconds": 0.05}
    root = str(tmp_path_factory.mktemp("bank"))
    hjm_system.write_bank(root, hjm_system.bank_pcm(config, 3), 48000)
    return root


def song(seed=4):
    return midi_songs.song(SONG_MIX, RATE, np.random.default_rng(seed))


def mixer_wav(bank_dir, smf):
    bank = hjm_mixer.Bank(bank_dir, RATE, 2, "cpu")
    return hjm_mixer.mix(smf, bank, 0, 127).save_as_wav()


def groups_counters():
    g = audio_ops.overlay_groups
    return g.groups, g.events, g.segments


def test_mixer_spans_are_called_once_a_mix_and_nest(bank_dir):
    smf = song()["smf"]
    bank = hjm_mixer.Bank(bank_dir, RATE, 2, "cpu")
    tracing.enable(True)
    with tracing.span("lncr.test.request"):
        hjm_mixer.mix(smf, bank, 0, 127)
    tracing.enable(False)
    recs = {r.name: r for r in tracing.records()}
    assert set(recs) == {"lncr.test.request", "lncr.hjm.notes",
                         "lncr.audio.overlay_groups"}
    totals = tracing.totals()
    assert totals["lncr.hjm.notes"]["calls"] == 1
    assert totals["lncr.audio.overlay_groups"]["calls"] == 1
    notes, groups = recs["lncr.hjm.notes"], recs["lncr.audio.overlay_groups"]
    outer = recs["lncr.test.request"]
    assert notes.parent is outer and groups.parent is outer
    assert outer.start <= notes.start < notes.end <= groups.start
    assert groups.end <= outer.end
    assert outer.child_ns == (notes.end - notes.start
                              + groups.end - groups.start)


def test_overlay_groups_counts_groups_survivors_and_slice_adds():
    rows, n = 1000, 300
    target = P.AudioClip.slient(RATE, 2, rows, device="cpu")
    a = P.AudioClip._from_array(RATE, 2, np.ones((n, 2)), device="cpu")
    b = P.AudioClip._from_array(RATE, 2, np.full((n // 2, 2), 2.0),
                                device="cpu")
    # group a: 0, 800 (cut short), 1000 (dropped), -100 (wraps: two
    # runs); group b: 5000 (dropped), 10; group a again: 999 (one row)
    groups = [(a, np.array([0, 800, 1000, -100]) / RATE),
              (b, np.array([5000, 10]) / RATE),
              (a, np.array([999]) / RATE)]
    before = groups_counters()
    target.overlay_groups(groups)
    after = groups_counters()
    assert (after[0] - before[0], after[1] - before[1],
            after[2] - before[2]) == (3, 5, 6)
    got = target.numpy()[:, 0]
    want = np.zeros(rows)
    want[0:300] += 1
    want[800:1000] += 1
    want[0:200] += 1                     # -100's rows from 0 on
    want[900:1000] += 1                  # and its first 100 wrapped
    want[10:160] += 2
    want[999] += 1
    np.testing.assert_array_equal(got, want)


def test_mixer_counters_against_the_song(bank_dir):
    s = song(5)
    _, groups = hjm_mixer.note_groups(s["smf"], 0, 127)
    bank = hjm_mixer.Bank(bank_dir, RATE, 2, "cpu")
    g0, d0 = groups_counters(), hjm_mixer.Bank.decodes
    hjm_mixer.mix(s["smf"], bank, 0, 127)
    g1, d1 = groups_counters(), hjm_mixer.Bank.decodes
    events = sum(len(v) for v in groups.values())
    assert events == SONG_MIX["notes"]
    # every onset lies inside the target, 1 s past the last: one slice
    # add an event
    assert (g1[0] - g0[0], g1[1] - g0[1], g1[2] - g0[2]) == (
        len(groups), events, events)
    assert d1 - d0 == len(groups)
    hjm_mixer.mix(s["smf"], bank, 0, 127)
    assert hjm_mixer.Bank.decodes == d1


def test_mixer_wav_bytes_equal_with_tracing_off_and_on(bank_dir):
    smf = song(6)["smf"]
    off = mixer_wav(bank_dir, smf)
    tracing.enable(True)
    on = mixer_wav(bank_dir, smf)
    tracing.enable(False)
    assert on == off
    assert "lncr.hjm.notes" in tracing.totals()


def test_mixer_with_tracing_off_records_nothing(bank_dir):
    before = groups_counters()
    mixer_wav(bank_dir, song(7)["smf"])
    assert tracing.records() == [] and tracing.totals() == {}
    assert groups_counters()[0] > before[0]
