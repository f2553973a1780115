"""The audio mixdown cell on the CPU: a traced run of its cut is correct
and reports the engine's span metrics and the three system-agnostic
ones, with no roofline where no kernel ran; the roofline's bytes and
operations against a brute count on a crafted mix; the roofline reader
against synthetic device events; the WAV parser on a file with another
chunk before its data; a port without the audio counters fails at
set-up."""

import struct
from types import SimpleNamespace as NS

import numpy as np
import pytest

from bench_torch.harness import main, peaks
from bench_torch.harness.trace import WINDOW, Trace
from bench_torch.metrics import audio_mix_roofline
from bench_torch.rooflines import audio_mix as roof
from bench_torch.systems.audio_mix import System, wav_samples
from bench_torch.tests import small

CELL = "audio_mixdown_112s"
AGNOSTIC = {"launches_per_frame", "device_idle",
            "pipeline_host_ms_per_frame"}
SPANS = {"overlay_ms_per_frame", "wav_ms_per_frame"}


def ev(name, start, end, dev="CUDA"):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=NS(name=dev))


def test_traced_run_reports_the_engine_and_agnostic_metrics(monkeypatch):
    """The CPU runs no device operation, so the profiled window gets one
    device-to-host copy over its first half: ``device_idle`` reads 50 %,
    and ``audio_mix_roofline``, which counts no copy to the host, has no
    device time to read."""
    def with_copy(events, frames):
        win = next(e for e in events if e.name == WINDOW
                   and e.device_type.name != "CUDA")
        lo, hi = win.time_range.start, win.time_range.end
        return Trace(list(events) + [ev("Memcpy DtoH (Device -> Pinned)",
                                        lo, (lo + hi) / 2)], frames)
    monkeypatch.setattr(main, "Trace", with_copy)
    c = small.cell(CELL)
    out = small.run(c, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == AGNOSTIC | SPANS
    assert out["metrics"]["device_idle"]["value"] == pytest.approx(50.0)
    assert all(out["metrics"][m]["value"] > 0 for m in SPANS)
    assert "audio_mix_roofline" not in out["metrics"]


def test_roofline_counts_against_brute_force():
    rate, rows, n, ch = 1000, 1000, 300, 2
    # frames 0, 100, 800 (cut to 200 rows), 999 (one row), 1000 and
    # 1500 (dropped), 700 twice
    offsets = [[0.0, 0.1, 0.8, 0.999, 1.0, 1.5], [0.7, 0.7]]
    brute = 0
    for mix in offsets:
        for s in (np.asarray(mix) * rate).astype(np.int64):
            brute += sum(1 for i in range(n) if 0 <= s + i < rows)
    assert brute == 300 + 300 + 200 + 1 + 2 * 300
    got = sum(roof.event_rows(o, rate, rows, n) for o in offsets)
    assert got == brute
    c = {"mixes": 2, "rows": rows, "channels": ch, "sound_rows": n,
         "sample_bytes": 4, "event_rows": got}
    n_bytes, n_ops = roof.work(c)
    assert n_bytes == 2 * (rows * ch * 4 * 2 + n * ch * 4 + rows * ch * 2)
    assert n_ops == brute * ch + 2 * rows * ch * 4


def test_roofline_reads_kernels_device_copies_and_fills():
    events = [ev(WINDOW, 0, 1000, "CPU"),
              ev("void at::native::vectorized_elementwise_kernel", 0, 100),
              ev("Memcpy DtoD (Device -> Device)", 100, 150),
              ev("Memset (Device)", 150, 160),
              ev("Memcpy HtoD (Pinned -> Device)", 200, 300),
              ev("Memcpy DtoH (Device -> Pinned)", 300, 700)]
    c = {"mixes": 1, "rows": 4939200, "channels": 2, "sound_rows": 22050,
         "sample_bytes": 4, "event_rows": 876 * 22050}
    run = NS(trace=Trace(events, 1), work={"audio_mix": c})
    n_bytes, _ = roof.work(c)
    assert n_bytes == pytest.approx(98.96e6, rel=1e-3)
    want = 100 * peaks.bound_s(*roof.work(c)) / 160e-6
    assert audio_mix_roofline.read(run) == pytest.approx(want)
    assert audio_mix_roofline.read(NS(trace=None, work={})) is None


def test_wav_samples_walks_the_chunks():
    pcm = np.arange(-6, 6, dtype="<i2").reshape(-1, 2)
    fmt = struct.pack("<hhiihh", 1, 2, 44100, 44100 * 4, 4, 16)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
            + b"LIST" + struct.pack("<I", 3) + b"abc\0"
            + b"data" + struct.pack("<I", pcm.nbytes) + pcm.tobytes())
    wav = b"RIFF" + struct.pack("<I", len(body)) + body
    np.testing.assert_array_equal(wav_samples(wav), pcm)
    with pytest.raises(ValueError, match="16-bit PCM"):
        wav_samples(wav.replace(struct.pack("<hh", 1, 2), struct.pack(
            "<hh", 3, 2), 1))
    with pytest.raises(ValueError, match="RIFF"):
        wav_samples(b"RIFX" + wav[4:])


@pytest.mark.parametrize("owner, attr", [
    ("overlay_many", "fft"), ("overlay_many", "events"),
    ("save_as_wav", "bytes")])
def test_port_without_a_counter_fails_at_setup(monkeypatch, owner, attr):
    from libnativecpurenderer_tpu_torch import AudioClip
    from libnativecpurenderer_tpu_torch.ops import audio_ops
    f = (audio_ops.overlay_many if owner == "overlay_many"
         else AudioClip.save_as_wav)
    monkeypatch.delattr(f, attr)
    made = []
    monkeypatch.setattr(System, "_clips", lambda self: made.append(self))
    c = small.cell(CELL)
    with pytest.raises(RuntimeError, match=f"{owner}.{attr}"):
        small.run(c)
    assert not made
