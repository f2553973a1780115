"""The 2D canvas of the PyTorch port (libnativecpurenderer_tpu_torch.
RenderContext, on the CPU) against the NumPy float64 oracle
(golden/cpu_reference.py) and against the JAX package's RenderContext.

Tolerances:
  * port vs the oracle (mirrors of tests/test_canvas_golden.py,
    tests/test_transform.py and test_fuzz_commands_match_oracle): exact.
    The port rounds every operation on its own, in the oracle's order
    (the JAX tests allow atol 1e-12 and one u8 level only because XLA may
    fuse a multiply into an add);
  * port vs the JAX package (whole slice, and a JAX flush replayed in the
    port): ``assert_matches_jax`` of tests/test_torch_canvas_kernel.py,
    for the reason stated there.
"""

import functools
import math

import numpy as np
import pytest
import torch
from test_fuzz_canvas import _apply_random_ops
from test_torch_canvas_kernel import assert_matches_jax

import libnativecpurenderer_tpu as R
import libnativecpurenderer_tpu_torch as P
from libnativecpurenderer_tpu.core import transform as jxf
from libnativecpurenderer_tpu.golden import cpu_reference as gold
from libnativecpurenderer_tpu.ops import executor as jex
from libnativecpurenderer_tpu_torch import atlas as patlas
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch import context as pcontext
from libnativecpurenderer_tpu_torch import interop
from libnativecpurenderer_tpu_torch.core import transform as xf
from libnativecpurenderer_tpu_torch.core.state import RenderState
from libnativecpurenderer_tpu_torch.ops import canvas_kernel as tck
from libnativecpurenderer_tpu_torch.ops import commands as C
from libnativecpurenderer_tpu_torch.ops import executor as pex
from libnativecpurenderer_tpu_torch.ops import sampling as psamp

torch.set_num_threads(1)

W, H = 48, 32


@pytest.fixture(autouse=True)
def port_f64_default():
    """Textures hold their texels in the default dtype, as in the JAX
    package, whose tests run with a float64 default (conftest)."""
    prev = pconfig.default_dtype()
    pconfig.set_default_dtype(torch.float64)
    yield
    pconfig.set_default_dtype(prev)


def ctx64(w=W, h=H, alpha=True):
    return P.RenderContext(w, h, alpha, torch.float64, device="cpu")


def make_pair(w=W, h=H, alpha=True):
    return ctx64(w, h, alpha), gold.GoldenContext(w, h, alpha)


def assert_match(ctx, g):
    np.testing.assert_array_equal(ctx.numpy_buffer(), g.float_buffer())
    np.testing.assert_array_equal(ctx.uint8_buffer(), g.uint8_buffer())


def both(ctx, g, name, *args, **kw):
    getattr(ctx, name)(*args, **kw)
    getattr(g, name)(*args, **kw)


# -- mirrors of tests/test_canvas_golden.py ------------------------------

def test_set_color_and_fill():
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.2, 0.4, 0.6, 0.8)
    both(ctx, g, "fill_color", 1.0, 0.0, 0.0, 0.25)
    assert_match(ctx, g)


def test_fill_with_color_transform():
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.1, 0.1, 0.1, 1.0)
    both(ctx, g, "set_color_transform", 0.5, 2.0, 1.0, 0.5)
    both(ctx, g, "fill_color", 0.8, 0.6, 0.4, 0.9)
    assert_match(ctx, g)


def test_rect_identity_and_transformed():
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    both(ctx, g, "draw_rect", 3.2, 4.7, 20.5, 10.1, 0.9, 0.5, 0.3, 0.7)
    both(ctx, g, "save_state")
    both(ctx, g, "translate", 10.0, 5.0)
    both(ctx, g, "rotate", 0.3)
    both(ctx, g, "scale", 1.3, 0.8)
    both(ctx, g, "draw_rect", 0.0, 0.0, 15.0, 8.0, 0.1, 0.9, 0.2, 0.5)
    both(ctx, g, "restore_state")
    both(ctx, g, "draw_rect", 5.0, 5.0, -3.0, 10.0, 1, 1, 1, 1)
    assert_match(ctx, g)


def test_circle():
    ctx, g = make_pair()
    both(ctx, g, "set_color", 1.0, 1.0, 1.0, 1.0)
    both(ctx, g, "draw_circle", 20.0, 15.0, 9.5, 0.2, 0.3, 0.9, 0.6)
    both(ctx, g, "rotate", -0.7)
    both(ctx, g, "draw_circle", 18.0, -4.0, 6.0, 0.9, 0.1, 0.1, 1.0)
    assert_match(ctx, g)


def test_line():
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    both(ctx, g, "draw_line", 2.0, 3.0, 40.0, 25.0, 4.0, 1.0, 0.8, 0.2, 0.9)
    both(ctx, g, "scale", 0.7, 1.2)
    both(ctx, g, "draw_line", 5.0, 30.0, 55.0, 1.0, 7.5, 0.3, 0.3, 1.0, 0.4)
    both(ctx, g, "draw_line", 5.0, 5.0, 5.0, 5.0, 3.0, 1, 1, 1, 1)
    both(ctx, g, "draw_line", 1.0, 1.0, 9.0, 9.0, 0.0, 1, 1, 1, 1)
    assert_match(ctx, g)


def test_vertical_gradient():
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.5, 0.5, 0.5, 1.0)
    both(ctx, g, "draw_vertical_grd", 4.0, 2.0, 30.0, 25.0,
         1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0)
    both(ctx, g, "rotate_degree", 15.0)
    both(ctx, g, "draw_vertical_grd", 10.0, 5.0, 20.0, 20.0,
         0.1, 0.9, 0.1, 1.0, 0.9, 0.1, 0.9, 0.2)
    assert_match(ctx, g)


def test_mut_gradient():
    ctx, g = make_pair()
    steps = [(0.0, (0, 0, 0, 0.0)), (0.5, (0, 0, 0, 0.6)),
             (1.0, (0, 0, 0, 1.0))]
    both(ctx, g, "set_color", 1.0, 1.0, 1.0, 1.0)
    ctx.draw_vertical_mut_grd(0, H * 0.4, W, H * 0.6, steps)
    for i, (p, s) in enumerate(steps[:-1]):
        np_, ns = steps[i + 1]
        g.draw_vertical_grd(0, H * 0.4 + H * 0.6 * p, W, H * 0.6 * (np_ - p),
                            s[0], s[1], s[2], s[3], ns[0], ns[1], ns[2],
                            ns[3])
    assert_match(ctx, g)


def test_pixels():
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.3, 0.3, 0.3, 1.0)
    both(ctx, g, "set_pixel", 5, 7, 0.1, 0.2, 0.3, 0.4)
    both(ctx, g, "set_color_transform", 0.5, 0.5, 0.5, 0.5)
    both(ctx, g, "apply_pixel", 6, 8, 1.0, 1.0, 1.0, 1.0)
    both(ctx, g, "apply_pixel", -1, 8, 1.0, 1.0, 1.0, 1.0)
    assert_match(ctx, g)
    assert ctx.get_color(5, 7) == (0.1, 0.2, 0.3, 0.4)
    assert ctx.get_color(-5, 700)[0] == g.buf[H - 1, 0, 0]


def _rand_tex(rng, w, h, alpha=True):
    arr = rng.random((h, w, 4 if alpha else 3))
    return (P.Texture(w, h, alpha, arr.astype(np.float64).tobytes(),
                      is_uint8=False),
            gold.GoldenTexture(arr, alpha))


def test_texture_fast_path():
    rng = np.random.default_rng(0)
    tex, gtex = _rand_tex(rng, 8, 8)
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    ctx.draw_texture(tex, 3.4, 2.7, 17.0, 12.0)
    g.draw_texture(gtex, 3.4, 2.7, 17.0, 12.0)
    assert_match(ctx, g)


def test_texture_fast_path_quirk_downscale():
    rng = np.random.default_rng(1)
    tex, gtex = _rand_tex(rng, 8, 8)
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    both(ctx, g, "scale", 0.25, 0.25)
    ctx.draw_texture(tex, 4.0, 4.0, 20.0, 20.0)
    g.draw_texture(gtex, 4.0, 4.0, 20.0, 20.0)
    assert_match(ctx, g)


def test_texture_transformed():
    rng = np.random.default_rng(2)
    tex, gtex = _rand_tex(rng, 10, 6)
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.1, 0.1, 0.1, 1.0)
    both(ctx, g, "translate", 8.0, 3.0)
    both(ctx, g, "rotate", 0.4)
    both(ctx, g, "scale", 1.5, 1.1)
    ctx.draw_texture(tex, 1.0, 1.0, 14.0, 9.0)
    g.draw_texture(gtex, 1.0, 1.0, 14.0, 9.0)
    assert_match(ctx, g)


def test_texture_color_transform_applies():
    rng = np.random.default_rng(3)
    tex, gtex = _rand_tex(rng, 4, 4)
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    both(ctx, g, "apply_color_transform", 0.9, 0.5, 0.2, 0.7)
    both(ctx, g, "scale", 2.0, 2.0)
    ctx.draw_texture(tex, 2.0, 2.0, 8.0, 8.0)
    g.draw_texture(gtex, 2.0, 2.0, 8.0, 8.0)
    assert_match(ctx, g)


def test_splitted_texture():
    rng = np.random.default_rng(4)
    tex, gtex = _rand_tex(rng, 12, 12)
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    both(ctx, g, "translate", 4.0, 4.0)
    both(ctx, g, "scale", 1.5, 1.5)
    ctx.draw_splitted_texture(tex, 0.0, 0.0, 20.0, 15.0, 0.25, 0.75, 0.1,
                              0.9)
    g.draw_splitted_texture(gtex, 0.0, 0.0, 20.0, 15.0, 0.25, 0.75, 0.1,
                            0.9)
    assert_match(ctx, g)


def test_rgb_context():
    rng = np.random.default_rng(5)
    tex, gtex = _rand_tex(rng, 6, 6, alpha=False)
    ctx, g = make_pair(alpha=False)
    both(ctx, g, "set_color", 0.2, 0.2, 0.2, 0.2)
    both(ctx, g, "draw_rect", 2.0, 2.0, 30.0, 20.0, 0.5, 0.6, 0.7, 0.5)
    both(ctx, g, "scale", 2.0, 1.0)
    ctx.draw_texture(tex, 1.0, 1.0, 10.0, 10.0)
    g.draw_texture(gtex, 1.0, 1.0, 10.0, 10.0)
    assert ctx.channels == 3
    assert ctx.get_buffer_size() == W * H * 3
    assert_match(ctx, g)


def test_resample_texture():
    rng = np.random.default_rng(6)
    tex, gtex = _rand_tex(rng, 9, 7)
    np.testing.assert_array_equal(tex.resample(4, 5).to_numpy(),
                                  gtex.resample(4, 5).buf)


def test_hit_effect_procedural_vs_golden():
    rng = np.random.default_rng(7)
    mask_arr = rng.random((16, 16, 4))
    mask = P.Texture(16, 16, True, mask_arr.astype(np.float64).tobytes(),
                     is_uint8=False)
    gmask = gold.GoldenTexture(mask_arr, True)
    het = P.HitEffectTexture(mask, seed=0.42, t=0.5, r=0.9, g=0.8, b=0.7)
    ghet = gold.hit_effect_texture(gmask, 0.42, 0.5, 0.9, 0.8, 0.7)
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    both(ctx, g, "translate", 6.0, 3.0)
    both(ctx, g, "scale", 1.4, 1.4)
    ctx.draw_texture(het, 0.0, 0.0, 20.0, 20.0)
    g.draw_texture(ghet, 0.0, 0.0, 20.0, 20.0)
    assert_match(ctx, g)
    np.testing.assert_array_equal(het.materialize().to_numpy(), ghet.buf)


def test_hit_effect_fast_path():
    rng = np.random.default_rng(8)
    mask_arr = rng.random((8, 8, 4))
    mask = P.Texture(8, 8, True, mask_arr.astype(np.float64).tobytes(),
                     is_uint8=False)
    gmask = gold.GoldenTexture(mask_arr, True)
    het = P.HitEffectTexture(mask, seed=0.1, t=0.3, r=1.0, g=0.5, b=0.2)
    ghet = gold.hit_effect_texture(gmask, 0.1, 0.3, 1.0, 0.5, 0.2)
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    ctx.draw_texture(het, 3.5, 2.5, 12.0, 12.0)
    g.draw_texture(ghet, 3.5, 2.5, 12.0, 12.0)
    assert_match(ctx, g)


def test_as_texture_roundtrip():
    ctx, g = make_pair()
    both(ctx, g, "set_color", 0.0, 0.0, 0.0, 1.0)
    both(ctx, g, "draw_rect", 5.0, 5.0, 20.0, 15.0, 0.9, 0.1, 0.5, 1.0)
    tex = ctx.as_texure()
    gtex = gold.GoldenTexture(g.buf.copy(), True)
    ctx2, g2 = make_pair()
    both(ctx2, g2, "set_color", 1.0, 1.0, 1.0, 1.0)
    both(ctx2, g2, "scale", 2.0, 2.0)
    ctx2.draw_texture(tex, 0.0, 0.0, 24.0, 16.0)
    g2.draw_texture(gtex, 0.0, 0.0, 24.0, 16.0)
    assert_match(ctx2, g2)


def test_get_version():
    assert P.get_version() == R.get_version() == 1


def test_bilinear_resample_option():
    w = 8
    ramp = np.zeros((w, w, 4))
    ramp[..., 0] = np.arange(w)[None, :] / (w - 1)
    ramp[..., 3] = 1.0
    tex = P.Texture(w, w, True, ramp.astype(np.float64).tobytes(),
                    is_uint8=False)
    out = tex.resample(16, 16, filter="bilinear").to_numpy()
    mid = out[8, 2:14, 0]
    d = np.diff(mid)
    np.testing.assert_allclose(d, d[0], atol=1e-9)
    np.testing.assert_allclose(out[3, :, 0], out[12, :, 0], atol=1e-12)
    np.testing.assert_array_equal(tex.resample(16, 16).to_numpy(),
                                  gold.GoldenTexture(ramp, True)
                                  .resample(16, 16).buf)
    # and the bilinear values are the JAX package's
    jtex = R.Texture(w, w, True, ramp.astype(np.float64).tobytes(),
                     is_uint8=False)
    np.testing.assert_allclose(
        out, jtex.resample(16, 16, filter="bilinear").to_numpy(),
        atol=1e-12, rtol=0)


# -- mirrors of tests/test_transform.py ----------------------------------

def test_transform_identity():
    assert xf.IDENTITY == jxf.IDENTITY == (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    assert xf.transform_point(xf.IDENTITY, 3.5, -2.0) == (3.5, -2.0)


def test_transform_compose_order_matches_canvas():
    m = xf.scale(xf.translate(xf.IDENTITY, 10.0, 20.0), 2.0, 3.0)
    assert xf.transform_point(m, 1.0, 1.0) == (12.0, 23.0)
    assert m == jxf.scale(jxf.translate(jxf.IDENTITY, 10.0, 20.0), 2.0, 3.0)


def test_transform_rotate():
    m = xf.rotate(xf.IDENTITY, math.pi / 2)
    x, y = xf.transform_point(m, 1.0, 0.0)
    assert abs(x) < 1e-12 and abs(y - 1.0) < 1e-12
    assert m == jxf.rotate(jxf.IDENTITY, math.pi / 2)


def test_transform_inverse_roundtrip():
    m = xf.compose(xf.IDENTITY, 1.5, 0.2, -0.3, 0.9, 40.0, -7.0)
    inv = xf.inverse(m)
    x, y = xf.transform_point(m, 3.0, 4.0)
    bx, by = xf.transform_point(inv, x, y)
    assert abs(bx - 3.0) < 1e-9 and abs(by - 4.0) < 1e-9
    assert inv == jxf.inverse(m)


def test_transform_inverse_degenerate_uses_1e9():
    inv = xf.inverse((0.0, 0.0, 0.0, 0.0, 5.0, 6.0))
    assert all(abs(v) < 1e13 for v in inv)
    assert inv == jxf.inverse((0.0, 0.0, 0.0, 0.0, 5.0, 6.0))


def test_transform_is_no_transform_sum_quirk():
    assert xf.is_no_transform(xf.IDENTITY)
    assert xf.is_no_transform(xf.scale(xf.IDENTITY, 0.25, 0.25))
    assert not xf.is_no_transform(xf.scale(xf.IDENTITY, 2.0, 2.0))
    assert xf.is_no_transform(xf.translate(xf.IDENTITY, -100.0, 0.0))
    assert not xf.is_no_transform(xf.translate(xf.IDENTITY, 100.0, 0.0))


def test_transform_aabb_truncation_and_clamp():
    box = xf.aabb(xf.IDENTITY, -5.0, 2.3, 15.7, 6.6, 9.0, 9.0)
    assert box == (0, 9, 2, 8)
    # the +-9e17 clamp before the C cast: infinite corners stay defined
    m = (math.inf, 0.0, 0.0, 1.0, 0.0, 0.0)
    assert xf.aabb(m, 1.0, 1.0, 2.0, 2.0, 9.0, 9.0) == \
        jxf.aabb(m, 1.0, 1.0, 2.0, 2.0, 9.0, 9.0) == (9, 9, 1, 3)


def test_transform_save_restore_stack():
    s = RenderState()
    s.scale(2.0, 2.0)
    s.set_color_transform(0.5, 0.6, 0.7, 0.8)
    s.save()
    s.translate(5.0, 5.0)
    s.apply_color_transform(0.5, 0.5, 0.5, 0.5)
    assert s.restore()
    assert s.matrix == xf.scale(xf.IDENTITY, 2.0, 2.0)
    assert s.color == (0.5, 0.6, 0.7, 0.8)
    assert not s.restore()


# -- mirror of test_fuzz_canvas.test_fuzz_commands_match_oracle -----------

@pytest.mark.parametrize("seed", range(6))
def test_fuzz_commands_match_oracle(seed):
    w, h = 40, 28
    rng = np.random.default_rng(seed)
    tex_pairs = []
    for _ in range(2):
        tw, th = int(rng.integers(2, 12)), int(rng.integers(2, 12))
        arr = rng.random((th, tw, 4))
        tex_pairs.append((
            P.Texture(tw, th, True, arr.astype(np.float64).tobytes(),
                      is_uint8=False),
            gold.GoldenTexture(arr, True)))
    ctx = ctx64(w, h)
    g = gold.GoldenContext(w, h, True)
    ctx.set_color(0, 0, 0, 1)
    g.set_color(0, 0, 0, 1)
    _apply_random_ops(rng, ctx, g, tex_pairs, 40)
    # NaN and inf where degenerate transforms make them: same places
    np.testing.assert_array_equal(ctx.numpy_buffer(), g.float_buffer())


# -- the whole slice against the JAX package -----------------------------

SW, SH = 256, 192
SX, SY = SW / 1920, SH / 1080


def bench_frame(ctx, texs, t):
    """bench.py:488-508's draw(t), every length scaled from 1920x1080 to
    SW x SH: a dim full-frame fill, a gradient, 8 lines, 30 split blits,
    12 plain blits (identity transform: the fast path) and 8 rects."""
    ctx.fill_color(0.05, 0.05, 0.08, 0.25)
    ctx.draw_vertical_grd(0, SH - 200 * SY, SW, 200 * SY,
                          0, 0, 0, 0, 0, 0, 0, 0.8)
    r2 = np.random.default_rng(42)
    for i in range(8):
        x = float(r2.uniform(100 * SX, SW - 100 * SX)
                  + 30 * SX * math.sin(t + i))
        y = float(r2.uniform(100 * SY, SH - 100 * SY))
        ctx.draw_line(x, y, x + 90 * SX, y + 40 * SY, 6.0 * SX,
                      0.9, 0.9, 1.0, 0.8)
    for i in range(30):
        x = float(r2.uniform(0, SW - 140 * SX)
                  + 40 * SX * math.sin(t * 2 + i))
        y = float(r2.uniform(0, SH - 140 * SY))
        ctx.draw_splitted_texture(texs[i % 4], x, y, 100.0 * SX, 50.0 * SY,
                                  0.1, 0.9, 0.0, 1.0)
    for i in range(12):
        ctx.draw_texture(texs[i % 4], float(r2.uniform(0, SW - 120 * SX)),
                         float(r2.uniform(0, SH - 120 * SY)), 80.0 * SX,
                         80.0 * SY)
    for i in range(8):
        ctx.draw_rect(float(r2.uniform(0, SW - 60 * SX)),
                      float(r2.uniform(0, SH - 60 * SY)),
                      40.0 * SX, 24.0 * SY, 0.2, 0.8, 0.4, 0.7)


def _tex_arrays():
    rng = np.random.default_rng(0)
    return [rng.random((32, 32, 4)) for _ in range(4)]


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_slice_bench_frames_match_jax(dt):
    np_dtype = {"f64": np.float64, "f32": np.float32}[dt]
    arrs = _tex_arrays()
    jctx = R.RenderContext(SW, SH, True, dtype=np_dtype)
    pctx = P.RenderContext(SW, SH, True, dtype=np_dtype, device="cpu")
    jt = [R.Texture._from_array(a, True) for a in arrs]
    pt = [P.Texture._from_array(a, True) for a in arrs]
    for k in range(3):
        bench_frame(jctx, jt, k * 0.016)
        bench_frame(pctx, pt, k * 0.016)
        jctx.flush()
        pctx.flush()
    got = pctx.numpy_buffer()
    assert got.dtype == np_dtype
    assert_matches_jax(got, jctx.numpy_buffer())
    du8 = pctx.uint8_buffer().astype(np.int16) - jctx.uint8_buffer()
    assert np.abs(du8).max() <= 1


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_jax_flush_replayed_in_port(dt):
    """A JAX context's recorded commands, framebuffer and atlas, carried
    over by interop, executed by the port as a flush does."""
    np_dtype = {"f64": np.float64, "f32": np.float32}[dt]
    jctx = R.RenderContext(SW, SH, True, dtype=np_dtype)
    jt = [R.Texture._from_array(a, True) for a in _tex_arrays()]
    bench_frame(jctx, jt, 0.0)
    jctx.flush()
    jctx.set_color_transform(0.9, 0.8, 1.0, 0.75)
    jctx.rotate(0.2)
    bench_frame(jctx, jt, 0.5)
    kinds, params = (np.array(a) for a in jctx._cmds.snapshot())
    fb0 = np.array(jctx._fb)
    atlas = np.array(jctx._store.device)
    jctx.flush()
    want = np.asarray(jctx._fb)

    t_dtype = torch.float64 if dt == "f64" else torch.float32
    k, p = interop.commands_to_torch(kinds, params, t_dtype, "cpu")
    fb, at = interop.canvas_to_torch(fb0, atlas, "cpu")
    assert fb.dtype == at.dtype == p.dtype == t_dtype
    assert k.dtype == torch.int32 and k.device.type == "cpu"
    got = pcontext.execute(fb, k, p, at, p.numpy())
    assert got is fb
    assert_matches_jax(got.numpy(), want)


# -- routing and reads ------------------------------------------------------

def test_flush_routes_arith_runs_to_k4(monkeypatch):
    """The bench frame makes exactly 1 K4-wrapper call a flush: fill,
    gradient, 8 lines, 30 split blits, 12 fast blits and 8 rects, with
    the atlas; its 42 blits are counted in ``render_span.sampled``.  A
    hit effect splits a run and runs over its window."""
    calls, evals = [], []
    real_span, real_cmds = tck.render_span, pex.render_commands

    @functools.wraps(real_span)   # its counters: the wrapper's own
    def span(fb, kinds, params, host_params=None, atlas=None):
        calls.append(kinds.tolist())
        assert atlas is ctx._store.atlas
        return real_span(fb, kinds, params, host_params, atlas)

    def cmds(fb, kinds, params, atlas=None, window=None):
        evals.append((list(kinds), window))
        return real_cmds(fb, kinds, params, atlas, window)

    monkeypatch.setattr(tck, "render_span", span)
    monkeypatch.setattr(pex, "render_commands", cmds)
    ctx = P.RenderContext(SW, SH, True, device="cpu")
    texs = [P.Texture._from_array(a, True) for a in _tex_arrays()]
    before = tck.render_span.sampled
    for k in range(2):
        bench_frame(ctx, texs, k * 0.016)
        ctx.flush()
    frame = ([C.KIND_FILL, C.KIND_VGRD] + [C.KIND_LINE] * 8
             + [C.KIND_SPLIT_TEX] * 30 + [C.KIND_TEX_FAST] * 12
             + [C.KIND_RECT] * 8)
    assert calls == [frame] * 2
    assert tck.render_span.sampled - before == 2 * 42
    # the K4 plain version evaluates its run over the full frame
    assert [k for k, w in evals] == calls
    assert all(w is None for _, w in evals)

    calls.clear()
    evals.clear()
    het = P.HitEffectTexture(texs[0], 0.3, 0.4, 0.9, 0.2, 0.5)
    ctx.draw_texture(texs[1], 5.0, 6.0, 30.0, 20.0)
    ctx.draw_texture(het, 40.0, 30.0, 50.0, 50.0)
    ctx.rotate(0.3)
    ctx.draw_rect(60.0, 10.0, 20.0, 12.0, 0.2, 0.8, 0.4, 0.7)
    ctx.flush()
    assert calls == [[C.KIND_TEX_FAST], [C.KIND_RECT]]
    samp = [(k, w) for k, w in evals if w is not None]
    assert [k for k, _ in samp] == [[C.KIND_HITEFFECT]]
    assert tck.render_span.sampled - before == 2 * 42 + 1


def test_sampling_window_equals_full_frame():
    """Each sampling command of a scene (fast, general, split blits and
    hit effects, partly off the frame) applied over its window equals the
    same command applied to the full frame."""
    ctx = ctx64(96, 64)
    rng = np.random.default_rng(3)
    tex = P.Texture._from_array(rng.random((12, 10, 4)), True)
    het = P.HitEffectTexture(tex, 0.3, 0.4, 0.9, 0.2, 0.5)
    ctx.fill_color(0.1, 0.2, 0.3, 1.0)
    ctx.draw_texture(tex, -5.5, 40.3, 30.0, 30.0)
    ctx.draw_texture(het, 70.2, -3.6, 20.0, 20.0)
    ctx.save_state()
    ctx.translate(30, 20)
    ctx.rotate(0.6)
    ctx.scale(1.3, 1.6)
    ctx.draw_texture(tex, 0.0, 0.0, 25.0, 14.5)
    ctx.draw_splitted_texture(tex, -8.0, 3.0, 30.0, 18.0, 0.2, 0.7, 0.1,
                              0.9)
    ctx.draw_texture(het, 5.0, 5.0, 22.0, 22.0)
    ctx.restore_state()
    kinds, params = ctx._cmds.snapshot()
    p = torch.from_numpy(params.copy())
    atlas = ctx._store.atlas
    fb0 = torch.rand(64, 96, 4, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    n = 0
    for i, k in enumerate(kinds.tolist()):
        if k not in pex.SAMPLING_KINDS:
            continue
        window = pex.sample_window(params[i, 6:10], 96, 64)
        assert window is not None and window != (0, 96, 0, 64)
        full = pex.render_commands(fb0.clone(), [k], p[i:i + 1], atlas)
        win = pex.render_commands(fb0.clone(), [k], p[i:i + 1], atlas,
                                  window)
        np.testing.assert_array_equal(win.numpy(), full.numpy())
        assert not torch.equal(full, fb0)
        n += 1
    assert n == 5


@pytest.mark.parametrize("box,want", [
    ((2.0, 10.0, 3.0, 7.0), (2, 10, 3, 7)),
    ((2.3, 9.5, 3.7, 7.0001), (3, 10, 4, 8)),
    ((-4.5, 200.0, -1.0, 1e30), (0, 96, 0, 64)),
    ((5.0, 5.0, 0.0, 64.0), None),
    ((5.2, 5.9, 0.0, 64.0), None),
    ((96.0, 120.0, 0.0, 64.0), None),
    ((float("nan"), 10.0, 0.0, 64.0), None),
    ((-float("inf"), float("inf"), 0.0, 64.0), (0, 96, 0, 64))])
def test_sample_window_bounds(box, want):
    assert pex.sample_window(np.array(box), 96, 64) == want


def test_quantize_u8_wraps_like_jax():
    v = np.array([-1.5, -0.01, 0.0, 0.5, 0.999, 1.0, 1.01, 2.5, 300.0,
                  -300.0, 1e10, -1e10, np.nan, np.inf, -np.inf, 0.123456])
    fb = np.stack([v, v[::-1], v * 0.5, v * 2.0], -1)[None]
    for dtype in (np.float64, np.float32):
        want = np.asarray(jex.quantize_u8(fb.astype(dtype), 4))
        got = pex.quantize_u8(torch.from_numpy(fb.astype(dtype))).numpy()
        np.testing.assert_array_equal(got, want)
    # above 1 and below 0 wrap (C cast), not clamp
    got = pex.quantize_u8(torch.tensor([[[1.5, -0.5, 2.0, 1.0]]])).numpy()
    assert got.tolist() == [[[382 % 256, -127 % 256, 510 % 256, 255]]]


def test_get_color_clamps_like_jax():
    jctx = R.RenderContext(W, H, True)
    pctx = ctx64()
    for c in (jctx, pctx):
        c.draw_vertical_grd(0, 0, W, H, 0.1, 0.2, 0.3, 0.4,
                            0.9, 0.8, 0.7, 0.6)
        c.set_pixel(0, H - 1, 1.0, 0.5, 0.25, 0.125)
    # (the gradient's values: within the JAX golden tolerance, see the
    # module docstring)
    for x, y in ((-5, 700), (1e9, -3), (2.7, 3.9), (W, H), (-0.5, H - 1)):
        assert pctx.get_color(x, y) == pytest.approx(jctx.get_color(x, y),
                                                     abs=1e-12, rel=0)
    assert pctx.get_color(-5, 700) == (1.0, 0.5, 0.25, 0.125)


def test_rgb_context_set_color_column_quirk():
    pctx, g = make_pair(alpha=False)
    jctx = R.RenderContext(W, H, False)
    for c in (pctx, g, jctx):
        c.set_color(0.2, 0.4, 0.6, 0.8)
    got = pctx.numpy_buffer()
    np.testing.assert_array_equal(got, g.float_buffer())
    np.testing.assert_array_equal(got, jctx.numpy_buffer())
    assert (got[1:, 0, 0] == 0.8).all() and got[0, 0, 0] == 0.2
    assert (got[:, 1:, 0] == 0.2).all()
    assert pctx.get_color(0, 5) == (0.8, 0.4, 0.6, 0.0)


def test_context_dtype_and_resize():
    assert P.RenderContext(4, 4, True, np.float64,
                           device="cpu")._fb.dtype == torch.float64
    assert P.RenderContext(4, 4, True, device="cpu")._fb.dtype == \
        torch.float64                       # the fixture's default
    with pytest.raises(ValueError):
        P.RenderContext(4, 4, True, torch.float16, device="cpu")
    ctx = ctx64(8, 6)
    ctx.fill_color(1, 1, 1, 1)
    ctx.resize(5, 3)
    assert ctx.numpy_buffer().shape == (3, 5, 4)
    assert not ctx.numpy_buffer().any()


# -- as_texure / as_texture_shared (tests/test_shared_texture.py:21-60,272)

def test_shared_sees_later_draws():
    ctx = ctx64(32, 24)
    ctx.fill_color(0.0, 0.0, 1.0, 1.0)
    shared = ctx.as_texture_shared()
    ctx.draw_rect(0, 0, 32, 24, 1.0, 0.0, 0.0, 1.0)
    dst = ctx64(32, 24)
    dst.draw_texture(shared, 0, 0, 32, 24)
    fb = dst.numpy_buffer()
    assert np.allclose(fb[12, 16, :3], [1.0, 0.0, 0.0])


def test_copy_stays_frozen():
    ctx = ctx64(32, 24)
    ctx.fill_color(0.0, 0.0, 1.0, 1.0)
    frozen = ctx.as_texure()
    ctx.draw_rect(0, 0, 32, 24, 1.0, 0.0, 0.0, 1.0)
    dst = ctx64(32, 24)
    dst.draw_texture(frozen, 0, 0, 32, 24)
    assert np.allclose(dst.numpy_buffer()[12, 16, :3], [0.0, 0.0, 1.0])


def test_shared_tracks_multiple_states():
    ctx = ctx64(32, 24)
    dst = ctx64(64, 24)
    ctx.fill_color(0.0, 1.0, 0.0, 1.0)
    shared = ctx.as_texture_shared()
    dst.draw_texture(shared, 0, 0, 32, 24)
    ctx.fill_color(1.0, 1.0, 0.0, 1.0)
    dst.draw_texture(shared, 32, 0, 32, 24)
    fb = dst.numpy_buffer()
    assert np.allclose(fb[12, 16, :3], [0.0, 1.0, 0.0])
    assert np.allclose(fb[12, 48, :3], [1.0, 1.0, 0.0])


def test_shared_onto_own_context():
    ctx = ctx64(32, 24)
    ctx.fill_color(0.0, 0.0, 0.0, 1.0)
    ctx.draw_rect(0, 0, 8, 8, 1.0, 1.0, 1.0, 1.0)
    shared = ctx.as_texture_shared()
    ctx.draw_splitted_texture(shared, 16, 12, 16, 12, 0.0, 1.0, 0.0, 1.0)
    fb = ctx.numpy_buffer()
    assert np.allclose(fb[2, 2, :3], [1.0, 1.0, 1.0])
    assert np.allclose(fb[13, 17, :3], [1.0, 1.0, 1.0])
    assert np.allclose(fb[22, 30, :3], [0.0, 0.0, 0.0])


def test_atlas_store_per_dtype_and_device():
    """One store for each (dtype, device); a texture is uploaded into a
    store the first time a context of that store samples it, cast to the
    store's dtype, and read back from its region unchanged."""
    arr = np.random.default_rng(9).random((5, 7, 4))
    tex = P.Texture._from_array(arr, True)
    assert tex._data.dtype == torch.float64      # the fixture's default
    s64 = patlas.get_store(torch.float64, "cpu")
    s32 = patlas.get_store(torch.float32, "cpu")
    assert s64 is patlas.get_store(torch.float64, torch.device("cpu"))
    assert s32 is not s64 and s32.atlas.dtype == torch.float32
    ox, oy = tex.region_for(s32)
    assert tex.region_for(s32) == (ox, oy)       # uploaded once
    np.testing.assert_array_equal(
        psamp.read_region(s32.atlas, ox, oy, 7, 5).numpy(),
        arr.astype(np.float32))
    ox, oy = tex.region_for(s64)
    np.testing.assert_array_equal(
        psamp.read_region(s64.atlas, ox, oy, 7, 5).numpy(), arr)
    patlas.reset_stores()
    assert patlas.get_store(torch.float64, "cpu") is not s64


def test_reads_and_state_match_jax():
    jctx = R.RenderContext(W, H, False)
    pctx = ctx64(alpha=False)
    for c in (jctx, pctx):
        c.set_color(0.1, 0.6, 0.3, 1.0)
        c.translate(3.0, 2.0)
        c.rotate_degree(20.0)
        c.apply_transform(1.0, 0.1, 0.0, 1.2, 0.5, 0.0)
        c.save_state()
        c.scale(1.5, 0.5)
        c.draw_rect(1.0, 1.0, 12.0, 9.0, 0.9, 0.2, 0.1, 1.0)
        c.restore_state()
        c.set_pixel(4, 4, 0.25, 0.5, 0.75, 1.0)
    assert pctx.get_transform() == jctx.get_transform()
    assert pctx.get_inverse_transform() == jctx.get_inverse_transform()
    assert pctx.get_buffer_size() == jctx.get_buffer_size() == W * H * 3
    assert pctx.get_buffer() == jctx.get_buffer()
    assert pctx.get_buffer_as_uint8() == jctx.get_buffer_as_uint8()
    fb = pctx.framebuffer()
    assert fb.shape == (H, W, 4) and fb.dtype == torch.float64


def test_pil_roundtrip_matches_jax():
    rng = np.random.default_rng(11)
    ctx = ctx64()
    ctx.fill_color(*rng.uniform(0, 1, 4))
    ctx.draw_circle(20.0, 14.0, 9.0, *rng.uniform(0, 1, 4))
    img = ctx.as_pilimg()
    assert img.mode == "RGBA" and img.size == (W, H)
    assert img.tobytes() == ctx.uint8_buffer().tobytes()
    for im in (img, img.convert("RGB"), img.convert("L")):
        np.testing.assert_array_equal(P.Texture.from_pilimg(im).to_numpy(),
                                      R.Texture.from_pilimg(im).to_numpy())
    with pytest.raises(TypeError):
        P.Texture.from_pilimg(np.zeros((2, 2, 4)))
    with pytest.raises(ValueError, match="size"):
        P.Texture(2, 2, True, b"\0" * 15)


def test_helpers_hit_effect_textures():
    mask = P.Texture._from_array(np.ones((8, 8, 4)), True)
    texs = P.Helpers.create_milthm_hit_effect_textures(mask, 5)
    assert [t.t for t in texs] == [0.0, 0.25, 0.5, 0.75, 1.0]
    assert len({t.seed for t in texs}) == 1
    assert all(isinstance(t, P.HitEffectTexture) and t.rgb == (
        0x96 / 0xFF, 0x90 / 0xFF, 0xFD / 0xFF) for t in texs)
    assert P.Helpers.wappered_bytes_to_python(b"ab") == b"ab"
    assert P.Helpers.get_wappered_bytes_data_size(b"abc") == 3
    with pytest.raises(ValueError):
        P.HitEffectTexture(P.Texture._from_array(np.ones((2, 2, 3)), False),
                           0.1, 0.2, 1, 1, 1)
    # a PtrCreatedTexture samples as its texture does
    ptr = P.PtrCreatedTexture(mask)
    a, b = ctx64(), ctx64()
    a.draw_texture(mask, 2.0, 3.0, 10.0, 7.0)
    b.draw_texture(ptr, 2.0, 3.0, 10.0, 7.0)
    np.testing.assert_array_equal(a.numpy_buffer(), b.numpy_buffer())
