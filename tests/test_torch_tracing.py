"""The port's host spans (``libnativecpurenderer_tpu_torch.tracing``) on the
CPU: off, a shared no-op that records nothing; on, parents, self time and
batch ids right (a fake clock); the spans of both frame pipelines, the
canvas flush and the mesh prep where their docstrings put them; their
profiler ranges nested as the spans are; and frames bit-equal with
tracing on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import libnativecpurenderer_tpu_torch as P
from libnativecpurenderer_tpu_torch import tracing
from libnativecpurenderer_tpu_torch.ops import canvas_kernel as tck
from libnativecpurenderer_tpu_torch.ops import executor
from libnativecpurenderer_tpu_torch.ops import raster3d as R

torch.set_num_threads(1)

W, H = 48, 32
MW, MH = 64, 48


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with tracing off, no ranges, no spans."""
    tracing.enable(False)
    tracing.ranges(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.ranges(False)
    tracing.reset()


class Sink:
    def __init__(self):
        self.frames = []

    def put_frame_u8(self, u8):
        self.frames.append(np.array(u8))


def textures():
    """Two textures and a hit effect of the first."""
    rng = np.random.default_rng(0)
    texs = [P.Texture._from_array(rng.random((16, 16, 4)), True)
            for _ in range(2)]
    return texs + [P.HitEffectTexture(texs[0], 0.3, 0.4, 0.9, 0.2, 0.5)]


def draw(ctx, texs, i):
    """A fill, two on-screen blits, a hit effect (a sampling command with
    a window) between them, one hit effect wholly off the frame (no
    window), one blit off the frame and two rects: two K4 runs."""
    ctx.fill_color(0.1, 0.1, 0.2, 1.0)
    ctx.draw_texture(texs[0], 2.0 + i, 3.0, 12.0, 10.0)
    ctx.draw_texture(texs[2], 20.0 - i, 12.0, 16.0, 16.0)
    ctx.draw_texture(texs[2], -40.0, 12.0, 16.0, 16.0)
    ctx.save_state()
    ctx.translate(20.0, 8.0)
    ctx.rotate(0.2 * i)
    ctx.draw_texture(texs[1], 0.0, 0.0, 14.0, 9.0)
    ctx.restore_state()
    ctx.draw_texture(texs[0], W + 40.0, 3.0, 12.0, 10.0)
    ctx.draw_rect(30.0, 20.0, 10.0, 6.0, 0.9, 0.4, 0.2, 0.8)
    ctx.draw_rect(4.0 + i, 22.0, 8.0, 5.0, 0.2, 0.8, 0.4, 0.7)


SAMPLED_A_FRAME = 1


def run_batched(frames=7, batch=3):
    """``frames`` frames recorded on a proxy through a BatchedVideoPipeline
    at ``batch``; the sink's frames and the submitted command lists."""
    rec = P.MultiThreadedVideoRenderContextPreparer(
        None, W, H, True, torch.float32, device="cpu")
    texs = textures()
    sink = Sink()
    pipe = P.BatchedVideoPipeline(sink, W, H, batch, torch.float32,
                                  device="cpu")
    lists = []
    for i in range(frames):
        draw(rec, texs, i)
        k, p = rec._cmds.snapshot()
        lists.append((k.copy(), p.copy()))
        pipe.submit(k, p)
        rec._cmds.clear()
    pipe.finish()
    return np.stack(sink.frames), lists


def mesh():
    """A 4x3 grid of quads (24 triangles) with a bump in z and vertex
    colours from the position."""
    xs, ys = np.meshgrid(np.linspace(-0.8, 0.8, 5), np.linspace(-0.7, 0.7, 4))
    z = 0.3 + 0.1 * np.sin(3 * xs) * np.cos(2 * ys)
    verts = np.stack([xs, ys, z], -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(3):
        for c in range(4):
            a = r * 5 + c
            faces += [[a, a + 1, a + 5], [a + 1, a + 6, a + 5]]
    faces = np.array(faces, np.int32)
    colors = np.concatenate([0.5 + 0.5 * verts[:, :3],
                             np.ones((len(verts), 1), np.float32)], 1)
    uvs = (0.5 + 0.5 * verts[:, :2]).astype(np.float32)
    return verts, faces, colors.astype(np.float32), uvs


def mvp(i):
    c, s = np.cos(0.1 * i), np.sin(0.1 * i)
    m = np.eye(4, dtype=np.float32)
    m[:2, :2] = [[c, -s], [s, c]]
    return m


def run_mesh(textured=False, frames=5, batch=2):
    verts, faces, colors, uvs = mesh()
    surface = (dict(uvs=uvs, tex_u8=np.random.default_rng(1).integers(
        0, 256, (8, 8, 4), dtype=np.uint8)) if textured
        else dict(colors=colors))
    sink = Sink()
    pipe = P.MeshVideoPipeline(sink, MW, MH, verts, faces, batch=batch,
                               device="cpu", **surface)
    for i in range(frames):
        pipe.submit(mvp(i))
    pipe.finish()
    return np.stack(sink.frames)


def test_off_is_one_shared_noop_and_records_nothing():
    a, b = tracing.span("lncr.x"), tracing.span("lncr.y", batch=3)
    assert a is b
    with a as got:
        assert got is None
    run_batched()
    run_mesh()
    assert tracing.totals() == {}
    assert tracing.records() == []


def test_parents_self_time_and_batches_on_a_fake_clock(monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(tracing, "clock", lambda: next(ticks))
    tracing.enable(True)
    with tracing.span("lncr.a", batch=4):          # 0 .. 70
        with tracing.span("lncr.b"):               # 10 .. 40
            with tracing.span("lncr.c", batch=9):  # 20 .. 30
                pass
        with tracing.span("lncr.c"):               # 50 .. 60
            pass
    with tracing.span("lncr.c"):                   # 80 .. 90
        pass
    recs = {(r.name, r.start): r for r in tracing.records()}
    a, b = recs["lncr.a", 0], recs["lncr.b", 10]
    assert (a.parent, a.batch, a.end) == (None, 4, 70)
    assert (b.parent, b.batch, b.end) == (a, 4, 40)
    assert (recs["lncr.c", 20].parent, recs["lncr.c", 20].batch) == (b, 9)
    assert (recs["lncr.c", 50].parent, recs["lncr.c", 50].batch) == (a, 4)
    assert (recs["lncr.c", 80].parent, recs["lncr.c", 80].batch) == (
        None, None)
    assert tracing.totals() == {
        "lncr.a": {"calls": 1, "ns": 70, "self_ns": 30},
        "lncr.b": {"calls": 1, "ns": 30, "self_ns": 20},
        "lncr.c": {"calls": 3, "ns": 30, "self_ns": 30}}
    tracing.reset()
    assert tracing.totals() == {} and tracing.records() == []


def test_span_open_at_reset_is_kept():
    tracing.enable(True)
    with tracing.span("lncr.a"):
        tracing.reset()
        with tracing.span("lncr.b"):
            pass
    assert {r.name for r in tracing.records()} == {"lncr.a", "lncr.b"}
    t = tracing.totals()["lncr.a"]
    assert t["self_ns"] == t["ns"] - tracing.totals()["lncr.b"]["ns"]


def flush_of(r):
    """The batch of the flush span around ``r`` (None outside one)."""
    p = r.parent
    while p is not None and p.name != "lncr.pipeline.flush":
        p = p.parent
    return None if p is None else p.batch


def test_batched_pipeline_spans_and_batch_ids():
    """Batch 3 over 7 frames: flushes 0, 1 and 2 (the remainder, at
    finish); upload, execute and copy_out carry their flush's id, the
    sink wait and delivery the drained batch's (one less, or the last
    batch's in finish's own drain); one sample span per sampling command
    with a window (the hit effects), one K4 span per run of the kinds K4
    takes."""
    tracing.enable(True)
    _, lists = run_batched()
    recs = tracing.records()
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    assert [r.batch for r in by["lncr.pipeline.flush"]] == [0, 1, 2]
    assert all(r.parent is None for r in by["lncr.pipeline.flush"])
    for name, n in (("lncr.pipeline.upload", 3), ("lncr.execute", 7),
                    ("lncr.pipeline.copy_out", 3)):
        assert len(by[name]) == n
        assert all(r.batch == flush_of(r) for r in by[name]), name
    for name in ("lncr.pipeline.sink_wait", "lncr.pipeline.deliver"):
        assert [(flush_of(r), r.batch) for r in by[name]] == [
            (1, 0), (2, 1), (None, 2)]
    # the sampling commands evaluated are those with a window
    windows = 0
    for kinds, params in lists:
        for i, k in enumerate(kinds):
            if k not in tck.KERNEL_KINDS:
                windows += executor.sample_window(
                    params[i, 6:10].astype(np.float32), W, H) is not None
    assert windows == len(by["lncr.execute.sample"]) == 7 * SAMPLED_A_FRAME
    runs = sum(len(tck.kernel_runs(k.tolist())) for k, _ in lists)
    assert len(by["lncr.execute.k4"]) == runs == 7 * 2
    for name in ("lncr.execute.sample", "lncr.execute.k4"):
        assert all(r.parent.name == "lncr.execute" for r in by[name])
    t = tracing.totals()
    assert t["lncr.pipeline.flush"]["ns"] >= sum(
        t[n]["ns"] for n in ("lncr.pipeline.upload", "lncr.execute"))
    assert not any(n.startswith("lncr.raster3d") for n in t)


@pytest.mark.parametrize("textured", [False, True])
def test_mesh_pipeline_one_prep_a_frame(textured):
    """5 frames at batch 2: one prep span a batch (2, 2 and 1 frames, one
    prep call each) under its flush, with one edges, bin and table span
    each inside it."""
    prep = (R.prepare_textured_frame if textured else R.prepare_frame)
    calls, frames = prep.calls, prep.frames
    tracing.enable(True)
    run_mesh(textured)
    assert (prep.calls - calls, prep.frames - frames) == (3, 5)
    recs = tracing.records()
    preps = [r for r in recs if r.name == "lncr.raster3d.prep"]
    assert len(preps) == 3
    assert [flush_of(r) for r in preps] == [0, 1, 2]
    assert [r.batch for r in preps] == [0, 1, 2]
    for child in ("lncr.raster3d.edges", "lncr.raster3d.bin",
                  "lncr.raster3d.table"):
        got = [r for r in recs if r.name == child]
        assert [r.parent for r in got] == preps, child
    t = tracing.totals()
    assert t["lncr.pipeline.upload"]["calls"] == 3
    assert t["lncr.pipeline.sink_wait"]["calls"] == 3
    assert "lncr.execute" not in t


def test_ranges_nest_as_the_spans_do():
    """With ranges on under a CPU profiler, each span is one
    ``record_function`` range of its name whose nearest ``lncr.`` parent
    range is its parent span's."""
    tracing.enable(True)
    tracing.ranges(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_batched(frames=4, batch=2)
        run_mesh(frames=2, batch=2)
    tracing.ranges(False)

    def lncr_parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("lncr."):
            p = p.cpu_parent
        return "" if p is None else p.name

    got = sorted((e.name, lncr_parent(e)) for e in prof.events()
                 if e.name.startswith("lncr."))
    want = sorted((r.name, r.parent.name if r.parent else "")
                  for r in tracing.records())
    assert got == want
    assert {"lncr.execute.sample", "lncr.raster3d.bin"} <= {n for n, _ in got}


def test_no_range_without_ranges(monkeypatch):
    def fail(name):
        raise AssertionError(f"a range for {name}")

    monkeypatch.setattr(tracing, "record_function", fail)
    tracing.enable(True)
    run_batched(frames=2, batch=2)
    assert tracing.totals()["lncr.execute"]["calls"] == 2


@pytest.mark.parametrize("which", ["batched", "mesh", "mesh_textured"])
def test_frames_bit_equal_with_tracing_on_and_off(which):
    def frames():
        if which == "batched":
            return run_batched()[0]
        return run_mesh(textured=which == "mesh_textured")

    off = frames()
    tracing.enable(True)
    on = frames()
    assert tracing.totals()["lncr.pipeline.flush"]["calls"] >= 3
    np.testing.assert_array_equal(off, on)
    assert off.shape[0] in (5, 7) and off.any()


# tools/torch_trace_cell.py: the spans' readings in a cell of the
# benchmark, and the idle gaps named by the program's spans


def trace_cell_tool():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "torch_trace_cell.py"
    spec = importlib.util.spec_from_file_location("torch_trace_cell", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ev(name, start, end, dev="CPU"):
    from types import SimpleNamespace as NS
    return NS(name=name, time_range=NS(start=start, end=end),
              device_type=NS(name=dev))


def test_idle_gaps_go_to_the_innermost_program_span():
    from bench_torch.harness.trace import WINDOW, Trace
    tool = trace_cell_tool()
    base = [ev(WINDOW, 0, 1000), ev("bench.submit", 0, 1000),
            ev("cudaLaunchKernel", 310, 312), ev("cudaMemcpyAsync", 700, 702),
            ev("k1", 310, 350, "CUDA"), ev("Memcpy DtoH", 700, 760, "CUDA")]
    program = [ev("lncr.pipeline.flush", 100, 900),
               ev("lncr.raster3d.prep", 150, 400),
               ev("lncr.raster3d.bin", 200, 300),
               # the ranges' device-side annotations are no device work
               ev("lncr.pipeline.flush", 100, 900, "CUDA"),
               ev("lncr.raster3d.prep", 150, 400, "CUDA")]
    plain = Trace(base, frames=2)
    t = Trace([tool.as_bench_span(e) for e in base + program], frames=2)
    assert t.busy_s == pytest.approx(plain.busy_s) == pytest.approx(100e-6)
    assert t.launch_calls == plain.launch_calls == 2
    # gaps [0, 310] (mid 155: the prep, outside the bin), [350, 700] and
    # [760, 1000] (mids 525, 880: the flush's own time)
    assert t.idle_by_span == {
        "bench.lncr.raster3d.prep": pytest.approx(310e-6),
        "bench.lncr.pipeline.flush": pytest.approx(590e-6)}
    assert plain.idle_by_span == {"bench.submit": pytest.approx(900e-6)}


def test_readings_and_batches_from_spans(monkeypatch):
    tool = trace_cell_tool()
    totals = {"lncr.pipeline.sink_wait": {"calls": 2, "ns": 4_000_000},
              "lncr.pipeline.upload": {"calls": 2, "ns": 1_000_000},
              "lncr.pipeline.copy_out": {"calls": 2, "ns": 3_000_000},
              "lncr.execute.sample": {"calls": 40, "ns": 80_000_000}}
    assert tool.readings(totals, 8) == {
        "sink_wait_ms_per_frame": 0.5, "batch_io_ms_per_frame": 0.5,
        "sampling_ms_per_frame": 10.0}
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(tracing, "clock", lambda: next(ticks))
    tracing.enable(True)
    for b in range(3):      # flush b drains b - 1
        with tracing.span(tool.FLUSH, b):
            if b:
                with tracing.span(tool.WAIT, b - 1):
                    pass
                with tracing.span(tool.DELIVER, b - 1):
                    pass
    # flush 0: 0 .. 10; flush 1: 20 .. 70 (batch 0's wait 30 .. 40,
    # delivery 50 .. 60); flush 2: 80 .. 130 (batch 1's 90 .. 100,
    # 110 .. 120): batches 0 and 1 are whole, batch 2 is not delivered
    got = tool.batches(tracing.records())
    assert got == pytest.approx({
        "batches": 2, "flush_ms": 30e-6, "sink_wait_ms": 10e-6,
        "deliver_ms": 10e-6, "flush_to_delivered_ms": 80e-6})


@pytest.mark.parametrize("name", ["milthm_chart", "mesh10k_gouraud"])
def test_trace_cell_tool_on_a_small_cell(name, monkeypatch):
    """Each cell of BENCHMARK.json cut to 160x96 on the CPU: an off and an
    on window, the profiled batch and the check; the on window reads its
    cell's metrics, the flush spans cover the pipeline's host time, and
    the sampled frames pass the cell's limit.  The chart's frame is one
    K4 run and fires no sample span (it draws no hit effect).  The
    windows' clock steps 0.1 s a reading, so each holds 8 frames (4
    batches) however fast the CPU is."""
    import itertools
    from bench_torch.tests import small
    tool = trace_cell_tool()
    monkeypatch.setattr(tool, "clock", itertools.count(0, 10 ** 8).__next__)
    out = tool.run(small.cell(name), 2 ** 33 + 5, 0.85, 1,
                   torch.device("cpu"))
    off, on = out["windows"]
    assert not off["tracing"] and on["tracing"]
    assert "spans" not in off and tracing.totals() == {}
    assert on["frames"] == off["frames"] == 8
    chart = name == "milthm_chart"
    want = {"sink_wait_ms_per_frame", "batch_io_ms_per_frame"}
    if not chart:
        want.add("mesh_prep_ms_per_frame")
    assert want == set(tool.READINGS) & set(on)
    assert on["flush_coverage"] >= 0.9
    if chart:
        assert on["spans"]["lncr.execute"]["calls"] == 1.0
        assert on["spans"]["lncr.execute.k4"]["calls"] == 1.0
        assert "lncr.execute.sample" not in on["spans"]
        assert on["k4_blits_per_frame"] > 0
    else:
        # one prep a batch
        assert on["spans"]["lncr.raster3d.prep"]["calls"] == \
            1.0 / small.cell(name).config["batch"]
        assert on["k4_blits_per_frame"] == 0
    assert all(n.startswith("lncr.") for n in out["profiled"]["idle_gaps"])
    c = out["correct"]
    assert c["frames_missing"] == 0
    assert c["worst_frame_off_share"] <= c["limit"]


def test_span_cost_reads_each_mode():
    tool = trace_cell_tool()
    got = tool.span_ns(n=2000)
    assert set(got) == {"off", "on", "on_ranges"}
    assert tracing.totals() == {}
