"""Shared textures of the PyTorch port on the CPU: the hit effect of a
shared mask, the recording proxy (``MultiThreadedVideoRenderContext
Preparer``) and the recycling of a shared texture's superseded atlas
regions behind ``BatchedVideoPipeline``.

Mirrors of tests/test_shared_texture.py (the plain aliases, the proxy,
the recycling, the held snapshot, a normal sampler of a pending proxy,
two interleaved pipelines), each on the port alone, with the same exact
u8 checks; and the hit effect of a shared mask against the JAX package
(first test) and against the port's own flushing-path render (last
tests).
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from test_torch_canvas_kernel import assert_matches_jax

import libnativecpurenderer_tpu as R
import libnativecpurenderer_tpu_torch as P
from libnativecpurenderer_tpu_torch import atlas as patlas
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch.ops import noise

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_f64_default():
    """Textures hold their texels in the default dtype, as in the JAX
    package, whose tests run with a float64 default (conftest).  Each
    test starts with empty stores and no pipeline to fence against."""
    prev = pconfig.default_dtype()
    pconfig.set_default_dtype(torch.float64)
    patlas.reset_stores()
    yield
    pconfig.set_default_dtype(prev)


def make_ctx(w=32, h=24, dtype=torch.float64):
    return P.RenderContext(w, h, True, dtype, device="cpu")


def make_rec(w=64, h=32, dtype=torch.float64):
    return P.MultiThreadedVideoRenderContextPreparer(None, w, h, True,
                                                     dtype, device="cpu")


class Sink:
    def __init__(self):
        self.frames = []

    def put_frame_u8(self, fr):
        self.frames.append(np.array(fr))


def make_pipe(sink, w=64, h=32, batch=2, dtype=torch.float64, fb0=None):
    return P.BatchedVideoPipeline(sink, w, h, batch, dtype, fb0,
                                  device="cpu")


def submit(pipe, rec):
    """Hand the recorded frame to the pipeline, then clear the buffer (the
    order the recycling guard requires)."""
    pipe.submit(*rec._cmds.snapshot())
    rec._cmds.clear()


# -- the hit effect of a shared mask (ROADMAP Queue 3 item 1) -------------

def _stale_mask_scene(M, ctx):
    """The hit effect of a shared mask, drawn in a second store after the
    mask was refreshed in the first: draws of (the mask in float64, the
    hit effect in float64, the hit effect in float32, the mask in
    float32), then the hit effect's materialised texels."""
    owner = ctx(8, 8, np.float64)
    owner.fill_color(1, 1, 1, 1)
    mask = owner.as_texture_shared()
    hit = M.HitEffectTexture(mask, 0.3, 0.5, 1.0, 0.5, 0.25)
    owner.set_color(0.2, 0.2, 0.2, 0.2)
    out = []
    for tex, dtype in ((mask, np.float64), (hit, np.float64),
                       (hit, np.float32), (mask, np.float32)):
        dst = ctx(16, 16, dtype)
        dst.draw_texture(tex, 0, 0, 16, 16)
        out.append(dst.numpy_buffer())
    return out + [hit.materialize().to_numpy()]


def test_hit_effect_follows_its_shared_mask():
    """The hit effect reads its mask's current texels: after the owner's
    set_color and a refresh of the mask, its draw in a store it has not
    used yet, its materialised texels and the mask's own draw there show
    the mask's alpha 0.2, as the JAX package's do (ROADMAP Queue 3 item
    1: the port's showed 1.0).  Port against JAX within
    assert_matches_jax's tolerance: the float64 draws and texels on every
    pixel; the float32 hit effect on the pixels whose dissolve noise (in
    float32, on the mask's texel grid: b_hiteffect's fast path samples
    texel min(X // 2, 6), min(Y // 2, 6)) lies more than 4e-3 from its
    threshold t.  Nearer, an ulp of torch.sin against XLA's sin, times
    the hash's 43758.5453, may flip the dissolve (chip_smoke.py's
    HIT_FLIP_SHARE)."""
    got = _stale_mask_scene(
        P, lambda w, h, d: P.RenderContext(w, h, True, d, device="cpu"))
    want = _stale_mask_scene(
        R, lambda w, h, d: R.RenderContext(w, h, True, dtype=d))
    g = torch.arange(8, dtype=torch.float32) / 8
    n = noise.circular_noise(g[:, None].expand(8, 8),
                             g[None, :].expand(8, 8), 50.0, 0.3)
    t = np.minimum(np.arange(16) // 2, 6)
    clear = (n - 0.5).abs().numpy()[t[:, None], t[None, :]] > 4e-3
    assert clear.mean() > 0.9
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype
        if i == 2:
            a, b = a[clear], b[clear]
        assert_matches_jax(a, b)
    for a in got[:2] + got[4:]:
        assert a[..., 3].max() == 0.2
    for a in got[2:4]:
        assert a[..., 3].max() == np.float32(0.2)
    assert (got[4][..., 3] == 0).any()      # the dissolve cut some texels


# -- mirrors of tests/test_shared_texture.py -------------------------------

def proxy_frame(rec, w=64, h=32, dtype=torch.float64):
    """The u8 frame of rec's recorded commands, rendered by a pipeline of
    batch 1."""
    sink = Sink()
    pipe = make_pipe(sink, w, h, 1, dtype)
    submit(pipe, rec)
    pipe.finish()
    return sink.frames[0]


@pytest.mark.parametrize("alias", ["shared", "copy"])
def test_proxy_samples_alias_at_record_point(alias):
    """test_shared_sees_later_draws and test_copy_stays_frozen, sampled by
    a recording proxy: the shared texture shows the red painted after
    sharing, the copy stays blue."""
    ctx = make_ctx()
    ctx.fill_color(0.0, 0.0, 1.0, 1.0)
    tex = ctx.as_texture_shared() if alias == "shared" else ctx.as_texure()
    ctx.draw_rect(0, 0, 32, 24, 1.0, 0.0, 0.0, 1.0)
    rec = make_rec(32, 24)
    rec.draw_texture(tex, 0, 0, 32, 24)
    want = (255, 0, 0) if alias == "shared" else (0, 0, 255)
    assert tuple(proxy_frame(rec, 32, 24)[12, 16, :3]) == want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_shared_in_recording_proxy_keeps_queued_commands(dtype):
    """A proxy does not flush when a shared texture refreshes (its queued
    commands would drop out of the frame); the refresh takes a fresh
    region, so each recorded sample shows the owner's state at its record
    point, in either store."""
    owner = make_ctx()
    owner.fill_color(0.0, 1.0, 0.0, 1.0)            # green
    shared = owner.as_texture_shared()
    rec = make_rec(dtype=dtype)
    rec.draw_rect(56, 24, 8, 8, 1.0, 0.0, 1.0, 1.0)  # queued before refresh
    rec.draw_texture(shared, 0, 0, 32, 24)          # left: green snapshot
    owner.fill_color(1.0, 1.0, 0.0, 1.0)            # then yellow
    rec.draw_texture(shared, 32, 0, 32, 24)         # right: fresh region
    assert rec._cmds.n == 3
    fb = proxy_frame(rec, dtype=dtype)
    assert tuple(fb[12, 16, :3]) == (0, 255, 0)     # pre-refresh sample
    assert tuple(fb[12, 48, :3]) == (255, 255, 0)   # post-refresh sample
    assert tuple(fb[28, 60, :3]) == (255, 0, 255)   # queued rect survived


def test_shared_refresh_regions_recycled_in_pipeline():
    """A shared texture refreshed every frame in a pipelined render does
    not grow the atlas without end: superseded regions return through the
    texture's pool once their batch was queued.  Each frame shows the
    owner's state at its record point."""
    owner = make_ctx()
    owner.fill_color(0.0, 0.0, 0.0, 1.0)
    shared = owner.as_texture_shared()
    rec = make_rec()
    sink = Sink()
    pipe = make_pipe(sink, batch=2)
    store = patlas.get_store(torch.float64, "cpu")
    marks, colors = [], []
    for i in range(20):
        c = (i % 4) / 4.0                       # exact binary fractions
        owner.fill_color(c, 0.25, 0.75, 1.0)    # owner redraws per frame
        colors.append(c)
        rec.draw_texture(shared, 0, 0, 64, 32)
        submit(pipe, rec)
        marks.append(store._y_next)
    pipe.finish()
    assert len(sink.frames) == 20
    for i, fr in enumerate(sink.frames):
        assert fr[16, 32, 0] == int(np.float64(colors[i]) * 255), i
        assert fr[16, 32, 2] == int(np.float64(0.75) * 255)
    assert marks[-1] == marks[12], marks
    assert len(shared._retired) <= 8, len(shared._retired)


@pytest.mark.parametrize("case", ["texture", "texture, grown", "hit"])
def test_shared_region_not_recycled_under_held_snapshot(case):
    """A preparer that swaps its buffer (end_of_frame) while the snapshot
    is not yet submitted holds the region guard: the snapshot's views keep
    the params array alive.  "texture, grown": the buffer outgrows its
    first array after the sample was recorded, so the views are of the
    second array; the guard holds all the same.  "hit": the held frame
    draws a hit effect of the shared texture, whose command reads the
    mask's region and guards it (the mask's alpha, which the hit effect
    shows, changes in the refresh cycles)."""
    owner = make_ctx()
    owner.fill_color(0.25, 0.0, 0.0, 1.0)
    shared = owner.as_texture_shared()
    tex = shared
    if case == "hit":
        tex = P.HitEffectTexture(shared, 0.37, 0.45, 0.9, 0.6, 0.3)
    rec = make_rec()
    sink = Sink()
    pipe = make_pipe(sink, batch=1)

    rec.draw_texture(tex, 0, 0, 64, 32)
    ctx = make_ctx(64, 32)
    ctx.draw_texture(tex, 0, 0, 64, 32)
    want = ctx.uint8_buffer()
    if case == "texture, grown":
        cap = rec._cmds.kinds.shape[0]
        for _ in range(cap):
            rec.set_pixel(-5, -5, 0.0, 0.0, 0.0, 1.0)    # off the frame
        assert len(rec._cmds.arrays) == 2
    rec.end_of_frame()
    held_k, held_p = rec.frames[0]

    # refresh cycles while the snapshot is held; the pipeline fences
    for i in range(6):
        owner.set_color(0.5, (i % 2) * 0.5, 1.0, 0.5)
        rec.draw_texture(shared, 0, 0, 64, 32)
        submit(pipe, rec)
        pipe.flush()

    # the held frame still samples the original texels
    pipe.submit(held_k, held_p)
    rec.frames.clear()
    pipe.finish()
    first = sink.frames[-1]
    if case == "hit":
        first[0, 0] = want[0, 0]
        assert (first[..., 3] == 255).mean() > 0.2
    else:
        assert first[16, 32, 0] == int(np.float64(0.25) * 255)
        assert first[16, 32, 2] == 0
    np.testing.assert_array_equal(first, want)


@pytest.mark.parametrize("first", ["context", "proxy", "submitted proxy"])
def test_pending_sample_keeps_its_state_under_another_refresh(first):
    """A sample recorded by one context (or proxy) and not yet run keeps
    the owner's state of its record point when another context samples
    the texture after the owner drew again: that refresh takes new
    regions instead of rewriting the pending sample's.  "submitted
    proxy": the proxy's frame was submitted and its buffer cleared (its
    guard let go), but the frame still waits in the pipeline.  The
    reference draws at once, so the first sample shows blue.  (The JAX
    package, and the port before, rewrote the regions in place, so the
    first sample showed red: ROADMAP Queue 3.)"""
    owner = make_ctx(8, 8)
    owner.fill_color(0, 1, 0, 1)                 # green
    shared = owner.as_texture_shared()
    owner.fill_color(0, 0, 1, 1)                 # blue, after sharing
    a = make_ctx(8, 8) if first == "context" else make_rec(8, 8)
    a.draw_texture(shared, 0, 0, 8, 8)           # pending: blue
    if first == "submitted proxy":
        sink = Sink()
        pipe = make_pipe(sink, 8, 8, batch=2)
        submit(pipe, a)
    owner.fill_color(1, 0, 0, 1)                 # red
    b = make_ctx(8, 8)
    b.draw_texture(shared, 0, 0, 8, 8)
    assert tuple(b.uint8_buffer()[4, 4]) == (255, 0, 0, 255)
    if first == "context":
        got = a.uint8_buffer()
    elif first == "proxy":
        got = proxy_frame(a, 8, 8)
    else:
        pipe.finish()
        got = sink.frames[0]
    assert tuple(got[4, 4]) == (0, 0, 255, 255)
    # with no pending sample left, the next refresh is in place
    store = patlas.get_store(torch.float64, "cpu")
    region = shared._regions[store]
    owner.fill_color(1, 1, 1, 1)
    b.draw_texture(shared, 0, 0, 8, 8)
    assert shared._regions[store] == region
    assert tuple(b.uint8_buffer()[4, 4]) == (255, 255, 255, 255)


@pytest.mark.parametrize("sampler", ["context", "proxy"])
def test_sampler_of_pending_proxy_owner_raises(sampler):
    """Sampling a shared texture whose owner is a recording proxy with
    queued commands raises, from a normal context (refreshing would flush
    the owner's pending frame) and from a proxy alike."""
    owner = make_rec(32, 24)
    owner.fill_color(0.1, 0.2, 0.3, 1.0)     # frame 0: still queued
    shared = owner.as_texture_shared()
    owner.draw_rect(0, 0, 8, 8, 1, 1, 1, 1)  # pending commands
    pending_before = owner._cmds.n
    dst = make_ctx() if sampler == "context" else make_rec(32, 24)
    with pytest.raises(ValueError, match="pending commands"):
        dst.draw_texture(shared, 0, 0, 32, 24)
    assert owner._cmds.n == pending_before   # the owner's queue survived
    assert dst._cmds.n == 0


def test_dual_pipeline_interleave_still_recycles():
    """Two pipelines fed in turn do not stall the recycling: each counts
    its own fences."""
    owner = make_ctx()
    owner.fill_color(0.0, 0.0, 0.0, 1.0)
    shared = owner.as_texture_shared()
    recs = [make_rec() for _ in range(2)]
    sinks = [Sink(), Sink()]
    pipes = [make_pipe(s, batch=2) for s in sinks]
    store = patlas.get_store(torch.float64, "cpu")
    marks, colors = [], []
    for i in range(24):
        j = i % 2
        c = (i % 4) / 4.0
        owner.fill_color(c, 0.25, 0.75, 1.0)
        colors.append(c)
        recs[j].draw_texture(shared, 0, 0, 64, 32)
        submit(pipes[j], recs[j])
        marks.append(store._y_next)
    for p in pipes:
        p.finish()
    for j in range(2):
        assert len(sinks[j].frames) == 12
        for fi, fr in enumerate(sinks[j].frames):
            want = int(np.float64(colors[2 * fi + j]) * 255)
            assert fr[16, 32, 0] == want, (j, fi)
    assert marks[-1] == marks[16], marks


def test_retired_regions_hold_their_store_weakly():
    """The recycling keeps no store alive: once the contexts and pipelines
    of a store and the store table let go of it, it dies, though the
    texture's retired sets and pool held regions of it; a refresh then
    allocates in the new store from scratch."""
    f32 = torch.float32
    owner = make_ctx()
    shared = owner.as_texture_shared()
    rec = make_rec(dtype=f32)
    pipe = make_pipe(Sink(), batch=1, dtype=f32)
    for c in (0.25, 0.5, 0.75, 1.0):
        owner.fill_color(c, c, c, 1.0)
        rec.draw_texture(shared, 0, 0, 64, 32)
        submit(pipe, rec)
    old = weakref.ref(patlas.get_store(f32, "cpu"))
    assert shared._retired and all(old() in r for _, r, _, _ in
                                   shared._retired)
    patlas.reset_stores()
    del rec, pipe
    gc.collect()
    assert old() is None and not shared._regions
    assert not any(r for _, r, _, _ in shared._retired)
    rec = make_rec(dtype=f32)
    owner.fill_color(0.0, 0.0, 0.0, 1.0)
    rec.draw_texture(shared, 0, 0, 64, 32)
    store = patlas.get_store(f32, "cpu")
    assert shared._regions[store] == (0, 0)
    # the sampled region set is retired but cannot be reused yet
    owner.fill_color(1.0, 1.0, 1.0, 1.0)
    rec.draw_texture(shared, 32, 0, 64, 32)
    assert shared._regions[store] == (32, 0)
    assert store._y_next == 24


# -- the hit effect of a shared mask in pending proxy frames ---------------

def _hit_frame(ctx, mask, hit, i):
    ctx.draw_texture(mask, 0, 0, 24, 24)
    ctx.save_state()
    ctx.translate(40, 12)
    ctx.rotate(0.3 * i)
    ctx.draw_texture(hit, -12, -12, 24, 24)
    ctx.restore_state()
    ctx.draw_texture(hit, 70, 4, 20, 20)


def _owner_frame(owner, i):
    a = (1 + i % 4) / 4.0
    owner.set_color(1.0, 0.5, 0.25, a)
    owner.draw_circle(8.0 + i % 5, 8.0, 3.0 + i % 3, 0.1, 0.2, 0.9, 1.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_hit_effect_of_shared_mask_in_pipeline(dtype):
    """Proxy frames draw a shared mask (a refresh into fresh regions) and
    two hit effects of it (which read the mask's current regions and
    guard them), across a refresh every frame, some frames held back
    after end_of_frame and submitted late, at batch 3; each frame equals
    the same frame drawn at its record point on a flushing RenderContext
    (from an owner of its own).  Not compared with the JAX package: its
    hit effect keeps the region the mask had when the hit effect was made,
    while a proxy's refresh moves the mask (ROADMAP Queue 3), so its
    frames show the mask's first state."""
    owners = [make_ctx(16, 16) for _ in range(2)]
    masks = [o.as_texture_shared() for o in owners]
    hits = [P.HitEffectTexture(m, 0.37, 0.45, 0.9, 0.6, 0.3)
            for m in masks]
    rec = make_rec(96, 32, dtype)
    sink = Sink()
    pipe = make_pipe(sink, 96, 32, 3, dtype)
    want, held = [], []
    store = patlas.get_store(dtype, "cpu")
    marks = []
    for i in range(12):
        for o in owners:
            _owner_frame(o, i)
        _hit_frame(rec, masks[0], hits[0], i)
        ctx = make_ctx(96, 32, dtype)
        _hit_frame(ctx, masks[1], hits[1], i)
        want.append(ctx.uint8_buffer())
        if i % 4 == 1:
            rec.end_of_frame()                   # held back two frames
            held.append(i)
        else:
            submit(pipe, rec)
            if i % 4 == 3:
                for _ in held:
                    pipe.submit(*rec.frames.pop(0))
                held.clear()
        marks.append(store._y_next)
    pipe.finish()
    order = [0, 2, 3, 1, 4, 6, 7, 5, 8, 10, 11, 9]
    assert len(sink.frames) == 12
    for k, fr in zip(order, sink.frames):
        np.testing.assert_array_equal(fr, want[k][..., :4], err_msg=str(k))
    lit = [int((sink.frames[j][:, 30:90, 3] > 0).sum()) for j in range(12)]
    assert min(lit) > 100                     # the hit effects drew
    assert marks[-1] == marks[8], marks
