"""The audio engine's spans and counters on the CPU: the five
``lncr.audio.*`` spans with their call counts and nesting, the FFT
route's counter against the scatter route at the bucketed threshold, the
events that survive the drop, the PCM bytes written, WAV bytes equal with
tracing on and off, and nothing recorded with tracing off."""

import numpy as np
import pytest
import torch

import libnativecpurenderer_tpu_torch as P
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch import tracing
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
