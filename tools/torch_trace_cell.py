"""The port's host spans (``libnativecpurenderer_tpu_torch.tracing``) in one
cell of ``BENCHMARK.json``, on the card: where the pipeline's host time
goes, what tracing costs, and which host work each idle gap of the device
lies under.

    python3 tools/torch_trace_cell.py --workload mesh10k_gouraud \\
        --seed 3100000011 --seconds 20 [--pairs 2]

The cell is set up and warmed as ``bench_torch/run.py`` does it (its
system, traffic, sink and closed loop).  Then ``--pairs`` pairs of
windows of ``--seconds`` each, tracing off then on, each window ended by
the pipeline's ``finish``; after the last one (on), one batch profiled
with ``torch.profiler`` and the spans' ranges on (the benchmark's
profiled inputs); then the sampled frames of that last window against
the cell's reference.  Prints one JSON object:

* ``span_ns``: a ``with span(...)`` block on this host, tracing off, on,
  and on with ranges (no profiler running), less the bare loop;
* ``windows``: each window's frames, loop seconds and frames a second,
  and the texture blits K4 took a frame (``render_span.sampled``; the
  hit effects, left to the executor, fire ``lncr.execute.sample``); for
  the on windows the readings the benchmark's program-span metrics
  take: ``sink_wait_ms_per_frame`` (``lncr.pipeline.sink_wait``),
  ``batch_io_ms_per_frame`` (``upload`` + ``copy_out``),
  ``mesh_prep_ms_per_frame`` (``lncr.raster3d.prep``) and
  ``sampling_ms_per_frame`` (``lncr.execute.sample``), each span's calls,
  ms and self ms a frame, ``pipeline_host_ms_per_frame`` as the benchmark
  takes it, ``flush_coverage`` (the flush spans less the sink's callbacks
  over it), and ``batches``, the flush, sink wait and delivery of each
  batch joined by batch id (medians);
* ``profiled``: launch calls a frame, the device's idle share, busy
  seconds and the idle gaps by innermost span (``lncr.*`` or
  ``bench.*``, "no span");
* ``correct``: ``worst_frame_off_share`` and ``frames_missing`` of the
  last window, beside the cell's limit.

Without a CUDA device it prints nothing and exits with 2.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from bench_torch.harness import main as bench  # noqa: E402
from bench_torch.harness import spec  # noqa: E402
from bench_torch.harness import traffic as traffic_mod  # noqa: E402
from bench_torch.harness.timeline import Sink, Spans, clock  # noqa: E402
from bench_torch.harness.trace import WINDOW, Trace  # noqa: E402
from libnativecpurenderer_tpu_torch import tracing  # noqa: E402
from libnativecpurenderer_tpu_torch.ops import canvas_kernel  # noqa: E402

READINGS = {
    "sink_wait_ms_per_frame": ("lncr.pipeline.sink_wait",),
    "batch_io_ms_per_frame": ("lncr.pipeline.upload",
                              "lncr.pipeline.copy_out"),
    "mesh_prep_ms_per_frame": ("lncr.raster3d.prep",),
    "sampling_ms_per_frame": ("lncr.execute.sample",),
}
FLUSH = "lncr.pipeline.flush"
WAIT = "lncr.pipeline.sink_wait"
DELIVER = "lncr.pipeline.deliver"


def span_ns(n: int = 10 ** 6) -> dict:
    """ns a ``with tracing.span(...)`` block costs: off, on, and on with
    ranges (a tenth of the loop: no profiler records), each less the bare
    loop's ns an iteration."""
    def loop(k, body):
        t0 = clock()
        for i in range(k):
            body()
            if i % 100_000 == 99_999:
                tracing.reset()
        return (clock() - t0) / k

    def block():
        with tracing.span("lncr.cost"):
            pass

    bare = loop(n, lambda: None)
    out = {}
    for name, on, rng, k in (("off", False, False, n), ("on", True, False, n),
                             ("on_ranges", True, True, n // 10)):
        tracing.enable(on)
        tracing.ranges(rng)
        out[name] = loop(k, block) - bare
    tracing.enable(False)
    tracing.ranges(False)
    tracing.reset()
    return out


def readings(totals: dict, frames: int) -> dict:
    """The program-span metrics' readings over ``frames`` frames; a
    reading whose spans did not run is left out."""
    out = {}
    for name, spans in READINGS.items():
        if any(s in totals for s in spans):
            out[name] = sum(totals[s]["ns"] for s in spans
                            if s in totals) / frames / 1e6
    return out


def batches(records) -> dict:
    """Each batch's flush, sink wait and delivery joined by batch id:
    medians (ms) over the batches that have all three, and of the time
    from a batch's flush start to the end of its delivery."""
    by: dict = {}
    for r in records:
        if r.name in (FLUSH, WAIT, DELIVER):
            by.setdefault(r.batch, {})[r.name] = r
    rows = [d for d in by.values() if len(d) == 3]
    if not rows:
        return {"batches": 0}

    def med(f):
        return statistics.median(f(d) for d in rows) / 1e6

    return {"batches": len(rows),
            "flush_ms": med(lambda d: d[FLUSH].end - d[FLUSH].start),
            "sink_wait_ms": med(lambda d: d[WAIT].end - d[WAIT].start),
            "deliver_ms": med(lambda d: d[DELIVER].end - d[DELIVER].start),
            "flush_to_delivered_ms": med(
                lambda d: d[DELIVER].end - d[FLUSH].start)}


def window(system, gen, sink, seconds: float, on: bool):
    """One closed-loop window with tracing ``on`` or off, left on after
    an on window; its loop and numbers."""
    loop = bench._Loop(system, gen, sink)
    spans = Spans()
    cb0 = sink.callback_ns
    blits0 = canvas_kernel.render_span.sampled
    if on:
        tracing.reset()
        tracing.enable(True)
    t0 = clock()
    t_end = t0 + int(seconds * 1e9)
    while clock() < t_end:
        loop.frame(spans)
    loop_s = (clock() - t0) / 1e9
    frames = len(loop.starts)
    out = {"tracing": on, "frames": frames, "loop_s": loop_s,
           "frames_per_s": frames / loop_s,
           "k4_blits_per_frame":
               (canvas_kernel.render_span.sampled - blits0) / frames}
    if on:
        totals = tracing.totals()
        pipe_ns = spans.ns["pipeline"]
        out["pipeline_host_ms_per_frame"] = pipe_ns / frames / 1e6
        out.update(readings(totals, frames))
        out["flush_coverage"] = (
            (totals[FLUSH]["ns"] - (sink.callback_ns - cb0)) / pipe_ns
            if FLUSH in totals else None)
        out["spans_per_frame"] = sum(t["calls"] for t in totals.values()) \
            / frames
        out["spans"] = {n: {"calls": t["calls"] / frames,
                            "ms": t["ns"] / frames / 1e6,
                            "self_ms": t["self_ns"] / frames / 1e6}
                        for n, t in sorted(totals.items())}
        out["batches"] = batches(tracing.records())
    return loop, out


def as_bench_span(e):
    """A profiler event of the program's ``lncr.*`` ranges renamed into
    the benchmark's ``bench.*`` spans, so that ``Trace`` takes it as a
    host span and its device-side annotation as no device work."""
    if not e.name.startswith("lncr."):
        return e
    return SimpleNamespace(name="bench." + e.name, time_range=e.time_range,
                           device_type=e.device_type)


def profiled(loop, batch: int, sync) -> Trace:
    """The benchmark's profiled batch of ``loop``, with the spans'
    ranges."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.reset()
    tracing.ranges(True)
    loop.sink.ranges = True
    first = len(loop.starts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for key in bench.profiled_keys(loop.gen, batch):
                loop.frame_marked(key)
            sync()
    loop.sink.ranges = False
    tracing.ranges(False)
    return Trace([as_bench_span(e) for e in prof.events()],
                 len(loop.starts) - first)


def run(cell: spec.Cell, seed: int, seconds: float, pairs: int,
        device) -> dict:
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = {"workload": cell.name, "seed": seed}
    sink = Sink(traffic_mod.seed_rng(seed, 4))
    gen = traffic_mod.generator(cell.mix, cell.config, seed)
    system = cell.system.System(cell.config, cell.mix, seed, device, sink)
    batch = system.batch
    sink.slots, sink.per_slot = batch, -(-bench.SAMPLE_FRAMES // batch)
    sink.reset()
    warm = bench._Loop(system, gen, sink)
    for _ in range(bench.WARM_BATCHES * batch):
        warm.frame(Spans())
    system.finish()
    sync()

    out["windows"] = []
    for i in range(2 * pairs):
        on = i % 2 == 1
        sink.reset()
        loop, w = window(system, gen, sink, seconds, on)
        out["windows"].append(w)
        if i < 2 * pairs - 1:
            tracing.enable(False)
            system.finish()
            sync()
    tr = profiled(loop, batch, sync)
    tracing.enable(False)
    tracing.reset()
    out["profiled"] = {
        "frames": tr.frames,
        "launches_per_frame": tr.launch_calls / tr.frames,
        "device_idle": (100.0 * (1.0 - tr.busy_s / tr.window_s)
                        if tr.device_ops else None),
        "busy_s": tr.busy_s, "window_s": tr.window_s,
        "idle_gaps": {n.removeprefix("bench.") if n.startswith("bench.lncr.")
                      else n: s for n, s in sorted(
                          tr.idle_by_span.items(), key=lambda kv: -kv[1])}}

    system.finish()
    sync()
    missing = len(loop.starts) - len(sink.arrivals)
    system.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    worst = bench.check(system, gen, loop.keys, sink.sample, device, False)
    out["correct"] = {"worst_frame_off_share": worst,
                      "limit": cell.limits.get("worst_frame_off_share"),
                      "frames_missing": missing}
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args(argv)
    if args.pairs < 1 or args.seconds <= 0:
        p.error("--pairs must be at least 1 and --seconds positive")
    if not torch.cuda.is_available():
        print("no CUDA device: nothing measured", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    out = run(cell, args.seed, args.seconds, args.pairs, device)
    out["span_ns"] = span_ns()
    out["card"] = bench.card_note()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
