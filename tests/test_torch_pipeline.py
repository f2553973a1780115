"""The 2D frame pipeline of the PyTorch port on the CPU: recorded frames
(a ``RenderContext``'s snapshots or a ``MultiThreadedVideoRenderContext
Preparer``'s) rendered by ``BatchedVideoPipeline``.

  * within the port (mirror of tests/test_pipeline.py::
    test_batched_equals_sequential): bit-equal to the same frames flushed
    one at a time by a ``RenderContext``;
  * port against the JAX package: the same recorded frames through both
    pipelines, u8 within one level (``assert_matches_jax``'s u8 contract,
    tests/test_torch_canvas_kernel.py), on bench.py's e2e mix at 192x108;
  * the device rule and the keywords the port takes.
"""

import functools
import math

import numpy as np
import pytest
import torch
from test_pipeline import FrameSink, draw

import libnativecpurenderer_tpu as R
import libnativecpurenderer_tpu_torch as P
from libnativecpurenderer_tpu.pipeline import BatchedVideoPipeline as JPipe
from libnativecpurenderer_tpu_torch import atlas as patlas
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch.ops import canvas_kernel as tck
from libnativecpurenderer_tpu_torch.ops import commands as C

torch.set_num_threads(1)

W, H = 48, 32
EW, EH = 192, 108          # bench.py's e2e mix, every length x 0.1
ES = EW / 1920


@pytest.fixture(autouse=True)
def port_f64_default():
    """Textures hold their texels in the default dtype, as in the JAX
    package, whose tests run with a float64 default (conftest)."""
    prev = pconfig.default_dtype()
    pconfig.set_default_dtype(torch.float64)
    yield
    pconfig.set_default_dtype(prev)


def e2e_frame(ctx, texs, t):
    """bench.py:720-732's draw(t) at EW x EH: a dim full-frame fill, 24
    split blits of 4 textures and 8 rects."""
    ctx.fill_color(0.05, 0.05, 0.08, 0.25)
    r2 = np.random.default_rng(42)
    for i in range(24):
        x = float(r2.uniform(0, EW - 140 * ES)
                  + 40 * ES * math.sin(t * 2 + i))
        y = float(r2.uniform(0, EH - 140 * ES))
        ctx.draw_splitted_texture(texs[i % 4], x, y, 100.0 * ES, 50.0 * ES,
                                  0.1, 0.9, 0.0, 1.0)
    for i in range(8):
        ctx.draw_rect(float(r2.uniform(0, EW - 60 * ES)),
                      float(r2.uniform(0, EH - 60 * ES)),
                      40.0 * ES, 24.0 * ES, 0.2, 0.8, 0.4, 0.7)


def e2e_textures(M):
    rng = np.random.default_rng(0)
    return [M.Texture._from_array(rng.random((128, 128, 4)), True)
            for _ in range(4)]


def e2e_fb0(nonzero: bool, dtype):
    if not nonzero:
        return None
    return np.random.default_rng(3).random((EH, EW, 4)).astype(dtype)


@pytest.mark.parametrize("source", ["context", "proxy"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_equals_sequential(source, dtype):
    """Frames recorded on a RenderContext (snapshot, submit, clear) or on a
    proxy (end_of_frame, then submitted), at batch 3 (two full batches
    and a remainder), are bit-equal to the same frames flushed one at a
    time from a zero framebuffer."""
    N = 7
    seq = []
    ctx = P.RenderContext(W, H, True, dtype, device="cpu")
    for i in range(N):
        draw(ctx, i)
        seq.append(ctx.uint8_buffer().copy())

    sink = FrameSink()
    pipe = P.BatchedVideoPipeline(sink, W, H, 3, dtype, device="cpu")
    if source == "context":
        rec = P.RenderContext(W, H, True, dtype, device="cpu")
    else:
        rec = P.MultiThreadedVideoRenderContextPreparer(
            None, W, H, True, dtype, device="cpu")
    for i in range(N):
        draw(rec, i)
        if source == "context":
            pipe.submit(*rec._cmds.snapshot())
            rec._cmds.clear()
        else:
            rec.end_of_frame()
    for k, p in getattr(rec, "frames", []):
        pipe.submit(k, p)
    pipe.finish()
    assert len(sink.frames) == N
    for a, b in zip(seq, sink.frames):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("nonzero_fb0", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_e2e_mix_matches_jax(dtype, nonzero_fb0):
    """bench.py's e2e mix recorded on each package's proxy, 7 frames at
    batch 3, through each package's BatchedVideoPipeline from the same
    fb0: the u8 frames within one level."""
    frames = {}
    for M in (R, P):
        kw = {"device": "cpu"} if M is P else {}
        rec = M.MultiThreadedVideoRenderContextPreparer(
            None, EW, EH, True, dtype, **kw)
        texs = e2e_textures(M)
        sink = FrameSink()
        pipe = (P.BatchedVideoPipeline if M is P else JPipe)(
            sink, EW, EH, 3, dtype, e2e_fb0(nonzero_fb0, dtype), **kw)
        for i in range(7):
            e2e_frame(rec, texs, i * 0.016)
            pipe.submit(*rec._cmds.snapshot())
            rec._cmds.clear()
        pipe.finish()
        frames[M] = np.stack(sink.frames)
    got, want = frames[P], frames[R]
    assert got.shape == want.shape == (7, EH, EW, 4)
    du8 = np.abs(got.astype(np.int16) - want)
    assert du8.max() <= 1, int((du8 > 0).sum())
    assert (got[..., :3] != got[:, :1, :1, :3]).any(-1).mean() > 0.02


def test_e2e_mix_runs_k4_twice_a_frame(monkeypatch):
    """Each frame of the e2e mix makes one K4-wrapper call (the fill, its
    24 split blits and the 8 rects; it ran the blits as sampling commands
    between two calls before K4 took them); the sink receives every frame
    once, in order."""
    calls = []
    real = tck.render_span

    @functools.wraps(real)   # its counters: the wrapper's own
    def span(fb, kinds, params, host_params=None, atlas=None):
        calls.append(kinds.tolist())
        return real(fb, kinds, params, host_params, atlas)

    monkeypatch.setattr(tck, "render_span", span)
    rec = P.MultiThreadedVideoRenderContextPreparer(
        None, EW, EH, True, torch.float32, device="cpu")
    texs = e2e_textures(P)
    sink = FrameSink()
    pipe = P.BatchedVideoPipeline(sink, EW, EH, 3, torch.float32,
                                  device="cpu")
    want = []
    for i in range(5):
        e2e_frame(rec, texs, i * 0.016)
        k, p = rec._cmds.snapshot()
        want.append(k.copy())
        pipe.submit(k, p)
        rec._cmds.clear()
    pipe.finish()
    assert calls == [[C.KIND_FILL] + [C.KIND_SPLIT_TEX] * 24
                     + [C.KIND_RECT] * 8] * 5
    assert [sum(k == C.KIND_SPLIT_TEX) for k in want] == [24] * 5
    assert len(sink.frames) == 5


def test_submit_copies_the_frame():
    """submit copies kinds and params: a buffer reused after submit does
    not change the pending frame."""
    ctx = P.RenderContext(W, H, True, device="cpu")
    sink = FrameSink()
    pipe = P.BatchedVideoPipeline(sink, W, H, 4, device="cpu")
    draw(ctx, 2)
    k, p = ctx._cmds.snapshot()
    want = ctx.uint8_buffer()
    pipe.submit(k, p)
    k[:] = C.KIND_NOOP
    p[:] = 0.0
    pipe.finish()
    np.testing.assert_array_equal(sink.frames[0], want)


def test_pipeline_registers_and_fences():
    """A pipeline registers for the shared-texture fences and counts one
    fence for each flush that had frames."""
    pipe = P.BatchedVideoPipeline(FrameSink(), W, H, 2, device="cpu")
    assert pipe in patlas._pipelines and pipe._fence_count == 0
    pipe.flush()
    assert pipe._fence_count == 0
    for _ in range(3):
        pipe.submit(np.zeros(0, np.int32), np.zeros((0, C.PARAM_W)))
    assert pipe._fence_count == 1
    pipe.finish()
    assert pipe._fence_count == 2 and len(pipe.cap.frames) == 3
    assert not pipe.cap.frames[0].any()      # an empty frame is fb0


@pytest.mark.parametrize("make", ["pipeline", "proxy"])
def test_cuda_device_raises_without_a_card(monkeypatch, make):
    """The default device="cuda" raises without a card: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        if make == "pipeline":
            P.BatchedVideoPipeline(FrameSink(), W, H)
        else:
            P.MultiThreadedVideoRenderContextPreparer(None, W, H, True)


@pytest.mark.parametrize("make,knob", [
    ("pipeline", "patch"), ("pipeline", "flush_mode"),
    ("pipeline", "vmap"), ("proxy", "patch")])
def test_unknown_keyword_raises_type_error(make, knob):
    """Keywords the port does not take (the JAX package's XLA routes have
    no counterpart) raise TypeError."""
    with pytest.raises(TypeError):
        if make == "pipeline":
            P.BatchedVideoPipeline(FrameSink(), W, H, device="cpu",
                                   **{knob: 1})
        else:
            P.MultiThreadedVideoRenderContextPreparer(
                None, W, H, True, device="cpu", **{knob: 1})


def test_fb0_shape_and_dtype():
    """fb0 is cast to the pipeline's dtype; a wrong shape raises."""
    fb0 = np.full((H, W, 4), 0.5, np.float64)
    pipe = P.BatchedVideoPipeline(FrameSink(), W, H, 2, np.float32, fb0,
                                  device="cpu")
    assert pipe._fb0.dtype == torch.float32
    with pytest.raises(ValueError, match="fb0"):
        P.BatchedVideoPipeline(FrameSink(), W, H, fb0=fb0[:, :-1],
                               device="cpu")
