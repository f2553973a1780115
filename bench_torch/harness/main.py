"""One run of one cell: set up, warm, a closed loop over the window, an
optional profiled sub-window, the drain, then the check of correctness
against the plain reference and the metrics.

The loop is closed, as an offline producer feeding an encoder is: frame
k + 1 starts as soon as ``submit`` of frame k returns.  The pipeline
takes frames in batches and hands each batch to the sink one batch
behind.  ``--trace 1`` runs the same window, then profiles
``PROFILED_BATCHES`` more batches with ``torch.profiler`` (a steady
sub-window: the whole window would make hundreds of thousands of
events), and reports the per-layer metrics instead of the end-to-end
ones.  A process that holds a module of the JAX stack or of the JAX
package once the run is over prints no result (``report``).
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import torch

from . import spec
from . import traffic as traffic_mod
from .timeline import Sink, Spans, clock, window_latencies_ms
from .trace import WINDOW, Trace

WARM_BATCHES = 2
PROFILED_BATCHES = 1
SAMPLE_FRAMES = 16          # at least, and as many of each place in a batch
# top-level modules a run of the port may not hold: the JAX stack and the
# JAX package the port was made from (its name is the port's, less _torch)
FOREIGN = ("jax", "jaxlib", "flax", "libnativecpurenderer" + "_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.trace = None
        self.library = None
        self.work: dict = {}
        self.__dict__.update(kw)


class _Loop:
    """Produces frames into a system, recording their starts, the spans
    and the key of each frame's input: frame i's input is
    ``gen.frame(keys[i])``, a pure function of the key, so the loop keeps
    no input and the check makes the sampled ones again."""

    def __init__(self, system, gen, sink):
        self.system, self.gen, self.sink = system, gen, sink
        self.starts: list = []
        self.keys: list = []

    def frame(self, spans: Spans) -> None:
        key = len(self.starts)
        inp = self.gen.frame(key)
        t0 = clock()
        self.starts.append(t0)
        self.keys.append(key)
        t1 = t0
        if self.system.record is not None:
            self.system.record(inp)
            t1 = clock()
            spans.add("record", t1 - t0)
        cb = self.sink.callback_ns
        self.system.submit(inp)
        spans.add("pipeline", clock() - t1 - (self.sink.callback_ns - cb))

    def frame_marked(self, key: int) -> None:
        """Frame ``gen.frame(key)`` inside profiler ranges named by
        layer."""
        from torch.profiler import record_function
        with record_function("bench.traffic"):
            inp = self.gen.frame(key)
        self.starts.append(clock())
        self.keys.append(key)
        if self.system.record is not None:
            with record_function("bench.record"):
                self.system.record(inp)
        with record_function("bench.submit"):
            self.system.submit(inp)


def profiled_keys(gen, batch: int) -> list:
    """The inputs of the profiled batches, the same in every run: spread
    evenly over a generator's ``period`` where it has one (a recorded
    script), else its first frames."""
    n = PROFILED_BATCHES * batch
    period = getattr(gen, "period", None)
    return [j * period // n for j in range(n)] if period else list(range(n))


def off_share(got, want) -> float:
    """Share of the places of two integer frames where some channel
    differs by more than one level: a frame's last axis is its channels,
    so the places are the pixels of (H, W, 4) u8 video frames, or the
    sample frames of an (N, 2) int16 mixed clip, checked to 1 LSB."""
    g = torch.as_tensor(got).to(want.device).int()
    return float(((g - want.int()).abs().amax(-1) > 1).double().mean())


def check(system, gen, keys, sample: dict, device, control: bool) -> float:
    """The worst off share of the sampled frames against the reference,
    which makes each sampled frame i again from its input; with
    ``control`` the control's frames of the same inputs take the
    program's place.  A frame is the unit the system delivers to the
    sink: a u8 video frame, or one mixed clip for a mixer."""
    worst = 0.0
    for i in sorted(sample):
        want = system.reference(gen.frame(keys[i]), device)
        got = (system.reference(gen.frame(keys[i]), device, control=True)
               if control else sample[i])
        worst = max(worst, off_share(got, want))
    return worst


def profile_window(loop, batch: int, sync) -> Trace:
    """Profile PROFILED_BATCHES more batches of the loop (the inputs of
    ``profiled_keys``), ended by a sync."""
    from torch.profiler import ProfilerActivity, profile, record_function
    loop.sink.ranges = True
    first = len(loop.starts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for key in profiled_keys(loop.gen, batch):
                loop.frame_marked(key)
            sync()
    loop.sink.ranges = False
    return Trace(prof.events(), len(loop.starts) - first)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_process: int, control: bool = False) -> dict:
    """One run of ``cell``; the result line's object (with
    ``frames_in_window``).  With ``control`` the control's frames stand
    in the program's place in the check, so ``correct`` is the
    control's."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    sink = Sink(traffic_mod.seed_rng(seed, 4))
    gen = traffic_mod.generator(cell.mix, cell.config, seed)
    system = cell.system.System(cell.config, cell.mix, seed, device, sink)
    batch = system.batch
    sink.slots, sink.per_slot = batch, -(-SAMPLE_FRAMES // batch)
    sink.reset()

    # set-up ends with the cell's own batch shape run twice and drained
    warm = _Loop(system, gen, sink)
    for _ in range(WARM_BATCHES * batch):
        warm.frame(Spans())
    system.finish()
    sync()
    sink.reset()

    loop = _Loop(system, gen, sink)
    spans = Spans()
    cpu0, thread0 = time.process_time_ns(), time.thread_time_ns()
    t_begin = clock()
    t_end = t_begin + int(seconds * 1e9)
    while clock() < t_end:
        loop.frame(spans)
    t_loop = clock()
    cpu_ns = time.process_time_ns() - cpu0
    thread_ns = time.thread_time_ns() - thread0
    n_window = len(loop.starts)
    tr = profile_window(loop, batch, sync) if trace else None

    error = None
    try:
        system.finish()
    except ValueError as exc:            # e.g. a raster's overflow
        error = str(exc)
        log(f"the program failed: {error}")
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    submitted = len(loop.starts)
    missing = submitted - len(sink.arrivals)

    # the program's state goes before the reference runs
    system.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    worst = check(system, gen, loop.keys, sink.sample, device, control)
    checks = {
        "frames_missing": {"value": missing, "limit": 0},
        "worst_frame_off_share": {
            "value": worst,
            "limit": cell.limits.get("worst_frame_off_share")},
    }
    correct = error is None and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    run = Run(setup_s=(t_begin - t_process) / 1e9, window_s=seconds,
              frames_in_window=sum(1 for a in sink.arrivals if a <= t_end),
              arrivals=[a for a in sink.arrivals if a <= t_end], batch=batch,
              latencies_ms=window_latencies_ms(loop.starts, sink.arrivals,
                                               t_end),
              spans=spans, trace=tr, library=cell.system.LIBRARY,
              frames_produced=n_window, loop_s=(t_loop - t_begin) / 1e9,
              cpu_s=cpu_ns / 1e9, thread_cpu_s=thread_ns / 1e9)
    if trace:
        run.work = system.work([gen.frame(k) for k in loop.keys[n_window:]],
                               device)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = spec.metric_reader(m["name"])
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": reader.UNIT}
    out = {"correct": bool(correct), "attempted": submitted,
           "failed": missing if error is None else max(missing, 1),
           "metrics": metrics, "device": device_info(device, peak, tr)}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["frames_in_window"] = n_window
    out["host"] = {"loop_s": run.loop_s, "cpu_s": run.cpu_s,
                   "thread_cpu_s": run.thread_cpu_s}
    out["checks"] = checks
    return out


def device_info(device, peak: int, tr) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def card_note() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_process: int) -> int:
    args = parse(argv)
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}: "
            f"no result")
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    log(f"card: {card_note()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   t_process)
    return report(out)


def foreign_modules() -> list:
    """The names of ``FOREIGN`` that ``sys.modules`` holds, compared by
    whole top-level names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def report(out: dict) -> int:
    """Log a run's host figures and checks, then print its result line;
    where the process holds a module of ``FOREIGN`` once the run is over,
    name it and print no result."""
    host = out.pop("host")
    log(f"frames submitted {out['attempted']}, in the window "
        f"{out.pop('frames_in_window')}; the loop's host clock "
        f"{host['loop_s']!r} s, process CPU {host['cpu_s']!r} s, main "
        f"thread CPU {host['thread_cpu_s']!r} s")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    found = foreign_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 3
    print(json.dumps(out), flush=True)
    return 0

