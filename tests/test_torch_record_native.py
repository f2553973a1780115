"""The port's record core (csrc/record.c, ``CommandBuffer.append_draw``)
against ``RenderContext._record_draw``'s Python body, bit for bit: every
draw recorded both ways must give the same kinds and the same bits of
params (their int64 views), raise the same exception where it raises,
and leave the buffer in the same state.  Mirrors tests/test_fastrec.py's
parity tests for the JAX package's native core."""

import math

import numpy as np
import pytest
import torch

import libnativecpurenderer_tpu_torch as P
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch.context import RenderContext
from libnativecpurenderer_tpu_torch.ops import _kernels
from libnativecpurenderer_tpu_torch.ops import commands as C

torch.set_num_threads(1)

W, H = 200, 150
INF = float("inf")
NAN = float("nan")

pytestmark = pytest.mark.skipif(
    _kernels.record_core() is None,
    reason=f"the record core cannot be built here: {_kernels.record_error}")


@pytest.fixture(autouse=True)
def port_f64_default():
    prev = pconfig.default_dtype()
    pconfig.set_default_dtype(torch.float64)
    yield
    pconfig.set_default_dtype(prev)


@pytest.fixture(scope="module")
def textures():
    """One set of textures for both passes: the atlas store is
    process-wide, so a texture made per pass would sit at another region
    and its rows would differ in (ox, oy) for reasons not of the record."""
    prev = pconfig.default_dtype()
    pconfig.set_default_dtype(torch.float64)
    try:
        rng = np.random.default_rng(5)
        tex = P.Texture._from_array(rng.random((8, 8, 4)), True)
        mask = P.Texture._from_array(rng.random((6, 10, 4)), True)
        het = P.HitEffectTexture(mask, 0.42, 0.5, 0.9, 0.8, 0.7)
    finally:
        pconfig.set_default_dtype(prev)
    return tex, het


def python_branch(monkeypatch):
    """Record with the Python body: no core loaded."""
    monkeypatch.setattr(_kernels, "record_core", lambda: None)


def record_both(monkeypatch, scene):
    """Run ``scene(ctx)`` on a fresh context with the core, then with the
    Python body; returns each pass's (kinds, params, errors, counts),
    counts being (native, python) draws the pass recorded."""
    out = []
    for native in (True, False):
        with monkeypatch.context() as mp:
            if not native:
                python_branch(mp)
            fn = RenderContext._record_draw
            n0, p0 = fn.native, fn.python
            ctx = P.RenderContext(W, H, True, torch.float64, device="cpu")
            errors = scene(ctx)
            k, p = ctx._cmds.snapshot()
            out.append((k.copy(), p.copy(), errors,
                        (fn.native - n0, fn.python - p0)))
    return out


def assert_rows_equal(a, b):
    (k1, p1), (k2, p2) = a, b
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(p1.view(np.int64), p2.view(np.int64))


# matrix families: each gives set_transform's six numbers from an rng
def _rotation(rng):
    a = float(rng.uniform(0, 2 * math.pi))
    return (math.cos(a), math.sin(a), -math.sin(a), math.cos(a),
            float(rng.uniform(-50, 250)), float(rng.uniform(-50, 200)))


FAMILIES = {
    "rotation": _rotation,
    "general": lambda rng: tuple(float(v) for v in rng.uniform(-3, 3, 6)),
    # det == 0: the inverse takes inv_det = 1e9
    "det0": lambda rng: (2.0, 4.0, 1.0, 2.0, float(rng.uniform(-9, 9)),
                         float(rng.uniform(-9, 9))),
    "scale_1e9": lambda rng: (float(rng.choice([-1e9, 1e9])), 0.0, 0.0,
                              float(rng.choice([-1e9, 1e9])),
                              float(rng.uniform(-5, 5)), 0.0),
    # corners at +-inf: boxes clamp, a line's floor(-inf) raises
    "inf": lambda rng: (float(rng.choice([1e300, -1e300])), 0.0, 0.0,
                        1e300, float(rng.choice([0.0, INF, -INF])), 0.0),
    # int entries: the core declines, the Python body records
    "ints": lambda rng: tuple(int(v) for v in rng.integers(-2, 3, 6)),
    # no transform: texture blits take the fast path
    "identity": lambda rng: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0),
}


def _draws(tex, het):
    """name -> draw(ctx, rng): one draw of each kind and box mode that
    ``_record_draw`` records."""
    def geom(rng):
        x, y = (float(v) for v in rng.uniform(-40, 260, 2))
        w, h = (float(v) for v in rng.uniform(0.5, 90, 2))
        return x, y, w, h

    def rgba(rng):
        return [float(v) for v in rng.uniform(0, 1, 4)]

    return {
        "set_color": lambda c, r: c.set_color(*rgba(r)),
        "fill_color": lambda c, r: c.fill_color(*rgba(r)),
        "rect": lambda c, r: c.draw_rect(*geom(r), *rgba(r)),
        "circle": lambda c, r: c.draw_circle(*geom(r)[:2],
                                             float(r.uniform(0.5, 40)),
                                             *rgba(r)),
        "line": lambda c, r: c.draw_line(*(float(v) for v in
                                           r.uniform(-40, 260, 4)),
                                         float(r.uniform(0.5, 7)),
                                         *rgba(r)),
        "vgrd": lambda c, r: c.draw_vertical_grd(*geom(r), *rgba(r),
                                                 *rgba(r)),
        "texture": lambda c, r: c.draw_texture(tex, *geom(r)),
        "hit_effect": lambda c, r: c.draw_texture(het, *geom(r)),
        "splitted": lambda c, r: c.draw_splitted_texture(
            tex, *geom(r), 0.1, 0.9, 0.0, 1.0),
    }


DRAWS = ("set_color", "fill_color", "rect", "circle", "line", "vgrd",
         "texture", "hit_effect", "splitted")


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("draw", DRAWS)
def test_draw_rows_match_python(monkeypatch, textures, draw, family):
    """40 draws of one kind under fuzzed matrices of one family, with
    colour transforms, recorded by the core and by the Python body: the
    same rows, bit for bit, and the same exceptions."""
    do = _draws(*textures)[draw]
    make = FAMILIES[family]

    def scene(ctx):
        rng = np.random.default_rng([DRAWS.index(draw),
                                     sorted(FAMILIES).index(family)])
        errors = []
        for _ in range(40):
            ctx.set_transform(*make(rng))
            ctx.apply_color_transform(
                *(float(v) for v in rng.uniform(0.5, 1.5, 4)))
            try:
                do(ctx, rng)
                errors.append(None)
            except (ValueError, OverflowError) as exc:
                errors.append(type(exc).__name__)
        return errors

    (k1, p1, e1, n1), (k2, p2, e2, n2) = record_both(monkeypatch, scene)
    assert e1 == e2
    assert_rows_equal((k1, p1), (k2, p2))
    assert len(k1) > 0 or all(e is not None for e in e1)
    assert n2[0] == 0 and sum(n1) == sum(n2)
    if family == "ints":      # the core declined every one
        assert n1[0] == 0
    else:
        assert n1[1] == 0


# (draw, matrix's a, matrix's e, x, the exception both branches raise)
BAD_BOXES = {
    "aabb_nan_matrix": ("rect", 1.0, NAN, 5.0, "ValueError"),
    "aabb_nan_x": ("rect", 1.0, 0.0, NAN, "ValueError"),
    # a = inf and x = 0: the left corners are NaN, min() keeps the NaN
    "aabb_nan_left": ("rect", INF, 0.0, 0.0, "ValueError"),
    # a = inf and x + w = 0: the right corners are NaN, and min() and
    # max() pass over them, as Python's builtins do: no exception
    "aabb_nan_right": ("rect", INF, 0.0, -10.0, None),
    "fast_nan_x": ("texture", 1.0, 0.0, NAN, "ValueError"),
    "quad_nan_matrix": ("line", 1.0, NAN, 5.0, "ValueError"),
    "quad_minus_inf": ("line", 1.0, -INF, 5.0, "OverflowError"),
}


@pytest.mark.parametrize("case", sorted(BAD_BOXES))
def test_bad_box_raises_like_python(monkeypatch, textures, case):
    """A NaN box raises ValueError, a line's infinite floor
    OverflowError, in both branches, recording nothing; NaN corners that
    Python's min() and max() pass over raise in neither."""
    tex, _ = textures
    draw, a, e, x, want = BAD_BOXES[case]

    def scene(ctx):
        ctx.set_transform(a, 0.0, 0.0, 1.0, e, 0.0)
        try:
            if draw == "rect":
                ctx.draw_rect(x, 3.0, 10.0, 10.0, 1.0, 1.0, 1.0, 1.0)
            elif draw == "texture":
                ctx.draw_texture(tex, x, 3.0, 10.0, 10.0)
            else:
                ctx.draw_line(x, 3.0, 40.0, 30.0, 2.0, 1.0, 1.0, 1.0, 1.0)
        except (ValueError, OverflowError) as exc:
            return type(exc).__name__, ctx._seq
        return None, ctx._seq

    (k1, p1, e1, n1), (k2, p2, e2, _) = record_both(monkeypatch, scene)
    assert e1 == e2 == (want, 0 if want else 1)
    assert_rows_equal((k1, p1), (k2, p2))
    assert len(k1) == (0 if want else 1)
    assert n1 == ((0, 0) if want else (1, 0))


@pytest.mark.parametrize("value", [np.float32(3.5), 2 ** 60, 7])
def test_declined_geometry_records_in_python(monkeypatch, value):
    """Geometry that the core cannot round as Python does (a numpy
    float32, an int beyond 2**52) is recorded by the Python body; a
    small int is the core's.  The rows are equal either way."""
    def scene(ctx):
        ctx.translate(1.5, 2.25)
        ctx.draw_rect(value, 3.0, 10.0, 10.0, 1.0, 1.0, 1.0, 1.0)

    (k1, p1, _, n1), (k2, p2, _, _) = record_both(monkeypatch, scene)
    assert_rows_equal((k1, p1), (k2, p2))
    assert n1 == ((1, 0) if value == 7 else (0, 1))


BAD_BUFFERS = {
    "float32_kinds": (lambda k, p: (k.astype(np.float32), p), 0, TypeError),
    "float32_params": (lambda k, p: (k, p.astype(np.float32)), 0,
                       TypeError),
    "strided_params": (lambda k, p: (k, p[:, ::2]), 0, TypeError),
    "row_past_end": (lambda k, p: (k, p), 4, IndexError),
    "negative_row": (lambda k, p: (k, p), -1, IndexError),
}


@pytest.mark.parametrize("case", sorted(BAD_BUFFERS))
def test_core_refuses_bad_buffers(case):
    """The core stores only into a 1D int32 kinds and a row-contiguous
    float64 params, at a row inside both, and raises otherwise."""
    make, row, exc = BAD_BUFFERS[case]
    kinds, params = make(np.zeros(4, np.int32), np.zeros((4, C.PARAM_W)))
    with pytest.raises(exc):
        _kernels.record_core().record_draw(
            kinds, params, row, C.KIND_RECT, (1.0, 0.0, 0.0, 1.0, 0.0, 0.0),
            (1.0, 1.0, 1.0, 1.0), RenderContext._BOX_AABB, 1.0, 2.0, 3.0,
            4.0, None, 10.0, 10.0)
    assert not np.asarray(kinds).any() and not np.asarray(params).any()


def test_buffer_grows_mid_frame(monkeypatch, textures):
    """300 draws grow the buffer past its 256 rows in the middle of a
    frame: a snapshot taken before the growth keeps its rows, the buffer
    keeps every array it held, and the rows equal the Python body's."""
    tex, _ = textures
    views = []

    def scene(ctx):
        rng = np.random.default_rng(11)
        for t in range(300):
            ctx.set_transform(*_rotation(rng))
            ctx.draw_splitted_texture(tex, 10.0 + t, 20.0, 30.0, 12.0,
                                      0.0, 1.0, 0.25, 0.75)
            if t == 99:
                k, p = ctx._cmds.snapshot()
                views.append((k, p, k.copy(), p.copy()))
        assert len(ctx._cmds.arrays) == 2
        assert ctx._cmds.arrays[0]() is views[-1][1].base
        return None

    (k1, p1, _, n1), (k2, p2, _, _) = record_both(monkeypatch, scene)
    assert_rows_equal((k1, p1), (k2, p2))
    assert len(k1) == 300 and n1 == (300, 0)
    for k, p, k_then, p_then in views:
        assert_rows_equal((k, p), (k_then, p_then))
        assert_rows_equal((k, p), (k1[:100], p1[:100]))


def test_chart_frames_match_python(monkeypatch):
    """24 frames of the chart cell's traffic replayed on a recording
    proxy at 1920x1080, as the benchmark's chart system replays them:
    every frame's rows are the Python body's, bit for bit, and the
    counters say which branch recorded them."""
    from bench_torch.harness import traffic

    mix = traffic.load("milthm_chart")
    rng = np.random.default_rng(3)
    tex = {n: P.Texture._from_array(
               rng.random((min(t["height"], 64), min(t["width"], 64), 4)),
               t["alpha"])
           for n, t in sorted(mix["textures"].items())}
    lines = mix["lines"][96:120]

    frames = []
    for native in (True, False):
        with monkeypatch.context() as mp:
            if not native:
                python_branch(mp)
            fn = RenderContext._record_draw
            n0, p0 = fn.native, fn.python
            rec = P.MultiThreadedVideoRenderContextPreparer(
                None, 1920, 1080, True, torch.float64, device="cpu")
            got = []
            for calls in lines:
                for name, *args in calls:
                    getattr(rec, name)(*[tex[a] if isinstance(a, str) else a
                                         for a in args])
                k, p = rec._cmds.snapshot()
                got.append((k.copy(), p.copy()))
                rec._cmds.clear()
            frames.append((got, (fn.native - n0, fn.python - p0)))
    (native_rows, n1), (python_rows, n2) = frames
    rows = sum(len(k) for k, _ in native_rows)
    draws = sum(1 for calls in lines for name, *_ in calls
                if name.startswith("draw_"))
    assert rows == draws > 24 * 50
    assert n1 == (rows, 0) and n2 == (0, rows)
    for a, b in zip(native_rows, python_rows):
        assert_rows_equal(a, b)


def test_core_builds_once(monkeypatch):
    """The core builds into the build directory under its hashed name,
    with the compiler's log beside it; a second build reuses the library
    without compiling; the loaded module is loaded once."""
    lib = _kernels.build("record")
    assert lib.parent == _kernels.BUILD_DIR
    name, tag = lib.stem.split("-")
    assert name == "record" and len(tag) == 16
    assert lib.with_suffix(".log").exists()
    assert isinstance(_kernels.build_log("record"), str)

    def no_compile(*a, **kw):
        raise AssertionError("the record core was compiled again")
    monkeypatch.setattr(_kernels.subprocess, "run", no_compile)
    assert _kernels.build("record") == lib
    assert _kernels.record_core() is _kernels.record_core()
    assert _kernels.record_core().__file__ == str(lib)


def test_core_builds_in_a_fresh_directory(monkeypatch, tmp_path):
    """With an empty build directory the core compiles there, leaves no
    temporary file, and loads."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    lib = _kernels.build("record")
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == \
        sorted([lib.name, lib.with_suffix(".log").name])
    calls = []
    real = _kernels.subprocess.run
    monkeypatch.setattr(_kernels.subprocess, "run",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    assert _kernels.build("record") == lib and calls == []
