"""device_idle, the launch count, the idle gaps by host span and the
library's kernel time, on synthetic profiler events."""

from types import SimpleNamespace as NS

import pytest

from bench_torch.harness import trace
from bench_torch.harness.main import Run
from bench_torch.metrics import device_idle, launches_per_frame


def ev(name, start, end, dev="CPU"):
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=NS(name=dev))


def events():
    return [
        ev(trace.WINDOW, 0, 1000),
        ev("bench.submit", 0, 400), ev("bench.record", 400, 700),
        ev("bench.submit", 700, 1000), ev("bench.sink", 800, 900),
        # a range's device-side annotation is no device work
        ev("bench.submit", 0, 1000, "CUDA"),
        ev("cudaLaunchKernel", 10, 12), ev("cudaLaunchKernel", 20, 22),
        ev("cudaLaunchKernelExC", 30, 32), ev("cudaMemcpyAsync", 40, 42),
        ev("cudaStreamSynchronize", 50, 52),
        # device: overlapping kernels, a copy, one past the window
        ev("void split_kernel<1>(int*)", 100, 300, "CUDA"),
        ev("elementwise", 250, 350, "CUDA"),
        ev("Memcpy DtoH (Device -> Pinned)", 820, 880, "CUDA"),
        ev("late", 990, 1200, "CUDA"),
    ]


def test_busy_idle_and_launches():
    t = trace.Trace(events(), frames=4)
    # busy: [100, 350] + [820, 880] + [990, 1000] = 320 us of 1000
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(320e-6)
    r = Run(trace=t)
    assert device_idle.read(r) == pytest.approx(68.0)
    assert t.launch_calls == 4
    assert launches_per_frame.read(r) == 1.0


def test_idle_gaps_named_by_innermost_span():
    t = trace.Trace(events(), frames=4)
    # gaps: [0,100] mid 50 submit; [350,820] mid 585 record;
    # [880,990] mid 935 submit (the sink ends at 900)
    assert t.idle_by_span["bench.submit"] == pytest.approx(210e-6)
    assert t.idle_by_span["bench.record"] == pytest.approx(470e-6)
    b = t.breakdown()
    assert b["idle_gaps"][0][0] == "bench.record"
    assert b["device_ops"][0][0] == "late"
    assert len(b["device_ops"]) <= 10


def test_no_device_events_reads_nothing():
    t = trace.Trace([ev(trace.WINDOW, 0, 10), ev("cudaLaunchKernel", 1, 2)],
                    frames=1)
    assert device_idle.read(Run(trace=t)) is None


def test_entry_names_and_library_time(monkeypatch):
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_112split_kernelILi1EEEvPi' for 'sm_90a'\n"
           "ptxas info    : Compiling entry function '_Z4plani' for "
           "'sm_90a'\n"
           "ptxas info    : Compiling entry function 'canvas_span_kernel' "
           "for 'sm_90a'\n")
    assert trace.entry_names(log) == {"split_kernel", "plan",
                                      "canvas_span_kernel"}
    t = trace.Trace(events(), frames=4)
    monkeypatch.setattr(trace, "loaded_library_log", lambda lib: log)
    assert t.library_kernel_s("tile_raster") == pytest.approx(200e-6)
    monkeypatch.setattr(trace, "loaded_library_log", lambda lib: None)
    assert t.library_kernel_s("tile_raster") is None


def test_merge_and_clip():
    assert trace.merge([(5, 6), (1, 3), (2, 4)]) == [[1, 4], [5, 6]]
    assert trace.clip([(0, 5), (8, 12)], 2, 10) == [(2, 5), (8, 10)]
