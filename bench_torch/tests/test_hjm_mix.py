"""The MIDI mixer cell on the CPU: an untraced run of its cut is correct
and reports the mixes a second and the set-up; a traced run is correct
and reports the mixer's span metrics, its roofline (over one kernel laid
on the profiled window, the CPU running none) and the three
system-agnostic metrics, with the bank decoded at set-up alone; the
roofline's bytes and operations against a brute count on a crafted mix;
the roofline reader against synthetic device events; a port without the
mixer's counters or its bank fails at set-up, before any bank is
written."""

from types import SimpleNamespace as NS

import pytest

from bench_torch.harness import main, peaks
from bench_torch.harness.trace import WINDOW, Trace
from bench_torch.metrics import hjm_mix_roofline
from bench_torch.rooflines import hjm_mix as roof
from bench_torch.systems import hjm_mix
from bench_torch.tests import small

CELL = "hjm_song_1500"
AGNOSTIC = {"launches_per_frame", "device_idle",
            "pipeline_host_ms_per_frame"}
MIXER = {"notes_ms_per_frame", "groups_ms_per_frame", "hjm_mix_roofline",
         "wav_ms_per_frame"}


def ev(name, start, end, dev="CUDA"):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=NS(name=dev))


def test_traced_run_reports_the_mixer_and_agnostic_metrics(monkeypatch):
    """The CPU runs no device operation, so the profiled window gets one
    kernel over its first quarter: ``device_idle`` reads 75 % and the
    roofline reads the least time over that kernel's."""
    seen = {}

    def with_kernel(events, frames):
        win = next(e for e in events if e.name == WINDOW
                   and e.device_type.name != "CUDA")
        lo, hi = win.time_range.start, win.time_range.end
        seen["kernel_s"] = (hi - lo) / 4 * 1e-6
        return Trace(list(events) + [ev("void at::native::add_kernel", lo,
                                        lo + (hi - lo) / 4)], frames)
    real_work = hjm_mix.System.work

    def work(self, inputs, device):
        seen["work"] = out = real_work(self, inputs, device)
        return out
    monkeypatch.setattr(main, "Trace", with_kernel)
    monkeypatch.setattr(hjm_mix.System, "work", work)
    c = small.cell(CELL)
    out = small.run(c, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == AGNOSTIC | MIXER
    assert out["metrics"]["device_idle"]["value"] == pytest.approx(75.0)
    assert all(out["metrics"][m]["value"] > 0 for m in MIXER)
    want = 100 * peaks.bound_s(*roof.work(seen["work"]["hjm_mix"])) \
        / seen["kernel_s"]
    assert out["metrics"]["hjm_mix_roofline"]["value"] == pytest.approx(want)
    replay = seen["work"]["audio_replay"]
    assert replay["decodes_in_run"] == 0
    counters = replay["counters"]
    assert counters["hjm_mixer.Bank.decodes"] == 0
    assert counters["overlay_groups.events"] == \
        replay["mixes"] * small.cell(CELL).mix["notes"]
    assert counters["overlay_groups.segments"] == \
        counters["overlay_groups.events"]


def test_untraced_run_reports_rate_and_setup():
    # frame_p95_ms does not list the cell: its tail swings too widely
    # between runs on the card to be bounded
    out = small.run(small.cell(CELL))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["metrics"]["frames_per_s"]["value"] > 0


def test_roofline_counts_against_brute_force():
    rows_a, rows_b, clip, ch = 1000, 700, 300, 2
    # mix a: starts 0, 100, 800 (cut to 200 rows), 999 (one row), 1000
    # and 1500 (outside) of one clip, and -50 (its last 250 rows) and 10
    # of another; mix b: 650 (50 rows) twice of one clip
    starts = [[[0, 100, 800, 999, 1000, 1500], [-50, 10]], [[650, 650]]]
    brute = [sum(1 for st in clips for s in st for i in range(clip)
                 if 0 <= s + i < rows)
             for clips, rows in zip(starts, (rows_a, rows_b))]
    assert brute == [300 + 300 + 200 + 1 + 250 + 300, 100]
    got = [sum(roof.event_rows(st, rows, clip) for st in clips)
           for clips, rows in zip(starts, (rows_a, rows_b))]
    assert got == brute
    # each clip's rows that some event lands, each counted once
    read = [sum(len({i for s in st for i in range(clip) if 0 <= s + i < rows})
                for st in clips)
            for clips, rows in zip(starts, (rows_a, rows_b))]
    assert read == [300 + 300, 50]
    assert [sum(roof.clip_rows_read(st, rows, clip) for st in clips)
            for clips, rows in zip(starts, (rows_a, rows_b))] == read
    c = {"mixes": 2, "samples": (rows_a + rows_b) * ch,
         "clip_samples": sum(read) * ch,
         "event_samples": sum(brute) * ch, "sample_bytes": 4}
    n_bytes, n_ops = roof.work(c)
    assert n_bytes == ((rows_a + rows_b) * ch * (4 + 4 + 2)
                       + sum(read) * ch * 4)
    assert n_ops == sum(brute) * ch + (rows_a + rows_b) * ch * 4


def test_roofline_reads_kernels_device_copies_and_fills():
    events = [ev(WINDOW, 0, 1000, "CPU"),
              ev("void at::native::vectorized_elementwise_kernel", 0, 100),
              ev("Memcpy DtoD (Device -> Device)", 100, 150),
              ev("Memset (Device)", 150, 160),
              ev("Memcpy HtoD (Pinned -> Device)", 200, 300),
              ev("Memcpy DtoH (Device -> Pinned)", 300, 700)]
    rows = 5_050_000
    c = {"mixes": 1, "samples": rows * 2, "clip_samples": 219 * 44100 * 2,
         "event_samples": 1500 * 44100 * 2, "sample_bytes": 4}
    run = NS(trace=Trace(events, 1), work={"hjm_mix": c})
    n_bytes, _ = roof.work(c)
    assert n_bytes == pytest.approx(1.783e8, rel=1e-3)
    want = 100 * peaks.bound_s(*roof.work(c)) / 160e-6
    assert hjm_mix_roofline.read(run) == pytest.approx(want)
    assert hjm_mix_roofline.read(NS(trace=None, work={})) is None


@pytest.mark.parametrize("owner, attr", [
    ("overlay_groups", "groups"), ("overlay_groups", "events"),
    ("overlay_groups", "segments"), ("Bank", "decodes"), ("hjm_mixer", "mix"),
    ("hjm_mixer", "Bank")])
def test_port_without_the_mixer_fails_at_setup(monkeypatch, owner, attr):
    from libnativecpurenderer_tpu_torch.apps import hjm_mixer
    from libnativecpurenderer_tpu_torch.ops import audio_ops
    where = {"overlay_groups": audio_ops.overlay_groups,
             "Bank": hjm_mixer.Bank, "hjm_mixer": hjm_mixer}[owner]
    monkeypatch.delattr(where, attr)
    made = []
    monkeypatch.setattr(hjm_mix, "write_bank",
                        lambda *a: made.append(a))
    c = small.cell(CELL)
    with pytest.raises(RuntimeError, match="the port lacks the mixer"):
        small.run(c)
    assert not made
