"""Kernel K4 of the PyTorch port (libnativecpurenderer_tpu_torch.ops.
canvas_kernel) against the JAX package's canvas span kernel run in
interpret mode.

On the CPU the K4 wrapper runs its plain torch version (the CUDA kernel
itself is compared with it on the card by chip_smoke.py).  Fed the same
recorded commands and framebuffer, port and JAX evaluate the same
operations in the same order, and the 2^-20 snap makes every membership
test agree.  The values do not always agree to the last bit: XLA:CPU
fuses a multiply into an add inside the JAX kernel and executor (a
CIRCLE, LINE or VGRD blend, or the VGRD lerp) in spite of their
optimization barriers, while the port rounds each op.  The port is the
one that matches the NumPy float64 oracle exactly
(``test_k4_matches_numpy_oracle_exactly``).  So ``assert_matches_jax``
holds port to JAX at:
  * float64: atol 1e-12, the JAX golden tests' own tolerance for the
    same contraction (``tests/test_canvas_golden.py:21-29``);
  * float32: atol 2^-18 (3.8e-6).  On the seeded scenes port and JAX
    float32 each differ from the float64 result by up to 1.4e-6 (float32
    resolves a coordinate in the hundreds of px to ~1e-5 px, coarser than
    the snap grid), and a one-ulp difference in a VGRD's t or a blend
    moves the value by up to 1.5e-6; that is far below one u8 level;
  * u8 of either: within 1 level, as the golden tests allow.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu.context import RenderContext as JaxContext
from libnativecpurenderer_tpu.golden import cpu_reference as gold
from libnativecpurenderer_tpu.ops import canvas_kernel as jck
from libnativecpurenderer_tpu.ops import executor as jex
from libnativecpurenderer_tpu.texture import Texture as JaxTexture
from libnativecpurenderer_tpu_torch.ops import canvas_kernel as tck
from libnativecpurenderer_tpu_torch.ops import commands as C
from libnativecpurenderer_tpu_torch.ops import executor as tex

torch.set_num_threads(1)

W, H = 256, 192
DTYPES = {"f64": (np.float64, torch.float64),
          "f32": (np.float32, torch.float32)}


def _record_hand(ctx):
    """test_canvas_kernel._record_arith plus a scaled line and an
    out-of-frame pixel: all 8 drawing kinds, rotated, scaled and
    translated transforms, a colour transform."""
    ctx.set_color(0.3, 0.2, 0.1, 0.9)
    ctx.fill_color(0.1, 0.2, 0.3, 1.0)
    ctx.draw_rect(20.0, 10.0, 90.0, 50.0, 0.9, 0.1, 0.1, 0.8)
    ctx.save_state()
    ctx.rotate(0.4)
    ctx.translate(30.0, 5.0)
    ctx.draw_circle(80.0, 60.0, 35.0, 0.1, 0.9, 0.2, 0.6)
    ctx.draw_line(10.0, 20.0, 180.0, 150.0, 5.0, 0.9, 0.9, 0.1, 0.9)
    ctx.scale(1.7, 0.6)
    ctx.draw_line(100.0, 200.0, 30.0, 40.0, 3.5, 0.2, 0.4, 0.9, 0.5)
    ctx.restore_state()
    ctx.set_color_transform(0.8, 0.9, 1.0, 0.7)
    ctx.draw_vertical_grd(5.0, 80.0, 200.0, 100.0,
                          1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 1.0)
    ctx.set_color_transform(1.0, 1.0, 1.0, 1.0)
    ctx.set_pixel(33, 44, 0.1, 0.2, 0.3, 0.4)
    ctx.apply_pixel(35, 44, 0.5, 0.6, 0.7, 0.8)
    ctx.apply_pixel(-3, 44, 0.5, 0.6, 0.7, 0.8)


def _record_random(ctx, rng, n_ops=40):
    """Seeded arithmetic draw stream: every arithmetic kind under random
    rotations, scales, translations and colour transforms."""
    for _ in range(n_ops):
        op = rng.integers(0, 12)
        if op == 0:
            ctx.fill_color(*rng.uniform(0, 1, 3), rng.uniform(0, 0.6))
        elif op == 1:
            ctx.draw_rect(rng.uniform(-20, W), rng.uniform(-20, H),
                          rng.uniform(1, 150), rng.uniform(1, 120),
                          *rng.uniform(0, 1, 4))
        elif op == 2:
            ctx.draw_circle(rng.uniform(0, W), rng.uniform(0, H),
                            rng.uniform(1, 80), *rng.uniform(0, 1, 4))
        elif op == 3:
            ctx.draw_line(rng.uniform(-10, W + 10), rng.uniform(-10, H + 10),
                          rng.uniform(-10, W + 10), rng.uniform(-10, H + 10),
                          rng.uniform(0.5, 9), *rng.uniform(0, 1, 4))
        elif op == 4:
            ctx.draw_vertical_grd(rng.uniform(-10, W), rng.uniform(-10, H),
                                  rng.uniform(1, W), rng.uniform(1, H),
                                  *rng.uniform(0, 1, 8))
        elif op == 5:
            ctx.set_pixel(int(rng.integers(-2, W + 2)),
                          int(rng.integers(-2, H + 2)), *rng.uniform(0, 1, 4))
        elif op == 6:
            ctx.apply_pixel(int(rng.integers(0, W)), int(rng.integers(0, H)),
                            *rng.uniform(0, 1, 4))
        elif op == 7:
            ctx.rotate(rng.uniform(-math.pi, math.pi))
        elif op == 8:
            ctx.scale(*rng.uniform(0.4, 1.8, 2))
        elif op == 9:
            ctx.translate(*rng.uniform(-40, 40, 2))
        elif op == 10:
            ctx.set_color_transform(*rng.uniform(0.4, 1.3, 4))
        else:
            ctx.set_color(*rng.uniform(0, 1, 4))


def _snapshot(record, alpha=True):
    ctx = JaxContext(W, H, alpha)
    record(ctx)
    kinds, params = ctx._cmds.snapshot()
    return np.array(kinds, np.int32), np.array(params, np.float64)


def assert_matches_jax(got, want):
    """Port vs JAX framebuffers: see the module docstring."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float64:
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=2.0 ** -18, rtol=0)
    du8 = (tex.quantize_u8(torch.from_numpy(got)).numpy().astype(np.int16)
           - tex.quantize_u8(torch.tensor(want)).numpy())
    assert np.abs(du8).max() <= 1


def _run_both(kinds, params, np_dtype, t_dtype, fb0=0.25):
    """(JAX K4 in interpret mode, port K4 wrapper) on the same inputs."""
    want = jck.render_span_kernel(
        jnp.full((H, W, 4), fb0, np_dtype), jnp.asarray(kinds),
        jnp.asarray(params), W, H, 64, 128, True)
    fb = torch.full((H, W, 4), fb0, dtype=t_dtype)
    got = tck.render_span(fb, torch.from_numpy(kinds),
                          torch.from_numpy(params).to(t_dtype))
    assert got is fb          # in place
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("alpha", [True, False])
def test_k4_matches_jax_kernel_hand_scene(dt, alpha):
    kinds, params = _snapshot(_record_hand, alpha)
    assert set(kinds.tolist()) == tck.ARITH_KINDS - {C.KIND_NOOP}
    want, got = _run_both(kinds, params, *DTYPES[dt])
    assert_matches_jax(got, want)


def test_k4_matches_numpy_oracle_exactly():
    """The plain version of K4 rounds every op as the float64 oracle
    (golden/cpu_reference.py) does: bit-equal on the hand scene."""
    g = gold.GoldenContext(W, H, True)
    _record_hand(g)
    kinds, params = _snapshot(_record_hand)
    fb = torch.zeros((H, W, 4), dtype=torch.float64)
    tck.render_span(fb, torch.from_numpy(kinds), torch.from_numpy(params))
    np.testing.assert_array_equal(fb.numpy(), g.float_buffer())


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("seed", range(3))
def test_k4_matches_jax_kernel_random(dt, seed):
    rng = np.random.default_rng(400 + seed)
    kinds, params = _snapshot(lambda c: _record_random(c, rng))
    want, got = _run_both(kinds, params, *DTYPES[dt])
    assert_matches_jax(got, want)


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_k4_noop_padding(dt):
    # NOOP rows (kind 0, all-zero params) are inert, as the JAX callers'
    # CMD_BUCKET padding relies on
    kinds, params = _snapshot(_record_hand)
    n = len(kinds)
    kp = np.zeros(jck.cmd_bucket(n), np.int32)
    kp[:n] = kinds
    pp = np.zeros((len(kp), C.PARAM_W))
    pp[:n] = params
    want, got = _run_both(kp, pp, *DTYPES[dt], fb0=0.0)
    _, unpadded = _run_both(kinds, params, *DTYPES[dt], fb0=0.0)
    assert_matches_jax(got, want)
    np.testing.assert_array_equal(got, unpadded)


def test_k4_leaves_unmasked_pixels_bit_identical():
    """A pixel no command admits keeps its bits, -0.0 and NaN included
    (the kernel neither reads nor writes a tile no command touches), and
    an empty run is a no-op."""
    ctx = JaxContext(W, H, True)
    ctx.draw_rect(-50.0, -40.0, 20.0, 10.0, 1, 1, 1, 1)      # off-frame
    ctx.set_pixel(W + 3, 5, 1, 1, 1, 1)                        # off-frame
    ctx.draw_circle(40.0, 30.0, 6.0, 0.5, 0.5, 0.5, 0.5)
    kinds, params = (np.array(a) for a in ctx._cmds.snapshot())
    fb0 = torch.full((H, W, 4), -0.0, dtype=torch.float64)
    fb0[100:, 200:] = math.nan
    fb = fb0.clone()
    tck.render_span(fb, torch.from_numpy(kinds), torch.from_numpy(params))
    touched = (fb.view(torch.int64) != fb0.view(torch.int64)).any(-1)
    assert 0 < int(touched.sum()) <= 13 * 13
    assert not touched[:20].any() and not touched[100:, 200:].any()
    empty = fb.clone()
    tck.render_span(empty, torch.zeros(0, dtype=torch.int32),
                    torch.zeros((0, C.PARAM_W), dtype=torch.float64))
    assert torch.equal(empty.view(torch.int64), fb.view(torch.int64))


def _jax_textures(seed=0):
    """Three seeded textures with alpha, of odd sizes, in the JAX
    package's atlas."""
    rng = np.random.default_rng(seed)
    return [JaxTexture._from_array(rng.random((h, w, 4)), True)
            for h, w in ((12, 10), (7, 16), (20, 20))]


def _atlas(ctx, t_dtype):
    """The JAX context's atlas as the port's, in ``t_dtype``."""
    return torch.from_numpy(np.array(ctx._store.device)).to(t_dtype)


def _record_blits(ctx, texs):
    """Texture blits of the three kinds K4 takes, sized to the frame: the
    fast path at the identity (one partly off the frame, one with a
    fractional box across a tile edge), and plain and split blits
    rotated, scaled and translated under a colour transform, partly off
    the frame."""
    w, h = ctx.width, ctx.height
    ctx.draw_texture(texs[0], -6.5, 0.3 * h, 0.2 * w, 0.25 * h)
    ctx.draw_texture(texs[1], 31.6, 30.3, 33.0, 9.5)
    ctx.save_state()
    ctx.translate(0.4 * w, 0.3 * h)
    ctx.rotate(0.7)
    ctx.scale(1.6, 0.8)
    ctx.set_color_transform(0.9, 0.7, 1.0, 0.8)
    ctx.draw_texture(texs[2], -20.0, -15.0, 45.0, 35.0)
    ctx.draw_splitted_texture(texs[1], 10.0, -30.0, 50.0, 24.0,
                              0.15, 0.85, 0.1, 0.95)
    ctx.restore_state()
    ctx.save_state()
    ctx.translate(w - 12.0, h - 9.0)
    ctx.rotate(-2.3)
    ctx.scale(0.7, 1.9)
    ctx.draw_splitted_texture(texs[2], -15.0, -10.0, 40.0, 30.0,
                              0.0, 1.0, 0.3, 0.6)
    ctx.draw_texture(texs[0], -25.0, -5.0, 30.0, 22.0)
    ctx.restore_state()


def _fractional_boxes(ctx):
    """Commands whose boxes have fractional edges: lines (their box is
    the transformed quad's, + 1 px), texture blits, and rects and
    gradients with boxes set by hand just past a tile edge, where float32
    rounds the edge back onto it."""
    _record_hand(ctx)
    ctx.draw_line(31.3, 10.0, 31.6, 90.0, 0.4, 0.9, 0.2, 0.3, 0.8)
    ctx.draw_line(5.0, 63.7, 150.0, 64.2, 0.7, 0.1, 0.8, 0.3, 0.9)
    _record_blits(ctx, _jax_textures())
    n0 = ctx._cmds.n
    ctx.draw_rect(0.0, 0.0, 64.0, 64.0, 0.5, 0.5, 0.1, 0.7)
    ctx.draw_vertical_grd(0.0, 0.0, 64.0, 64.0, 1, 0, 0, 1, 0, 1, 0, 1)
    p = ctx._cmds.params
    p[n0, 6:10] = (0.0, 32.000000001, 0.0, 64.3)
    p[n0 + 1, 6:10] = (31.9999999, 64.0, 32.5, 96.000001)


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape", [(256, 192), (100, 70)])
def test_k4_tile_culling_matches_full_frame(dt, shape):
    """What the kernel's in-tile culling does, on the plain version: each
    32x32 tile evaluated over its own window with only the commands the
    kernel's test (made in the fb's type) keeps, equals the full-frame
    evaluation of every command.  Partial edge tiles included."""
    w, h = shape
    ctx = JaxContext(w, h, True)
    _fractional_boxes(ctx)
    kinds, params64 = ctx._cmds.snapshot()
    _, t_dtype = DTYPES[dt]
    params = torch.from_numpy(np.array(params64)).to(t_dtype)
    p_np = params.numpy()
    atlas = _atlas(ctx, t_dtype)
    assert tck.TEXTURE_KINDS <= set(kinds.tolist())
    full = tex.render_commands(torch.full((h, w, 4), 0.25, dtype=t_dtype),
                               kinds.tolist(), params, atlas)
    tiled = torch.full((h, w, 4), 0.25, dtype=t_dtype)
    touched = [tck.tiles_touched(k, p_np[i], w, h)
               for i, k in enumerate(kinds.tolist())]
    culled = 0
    for oy in range(0, h, 32):
        for ox in range(0, w, 32):
            keep = [i for i in range(len(kinds))
                    if touched[i][oy // 32, ox // 32]]
            culled += len(kinds) - len(keep)
            tex.render_commands(tiled, [int(kinds[i]) for i in keep],
                                params[keep], atlas,
                                window=(ox, min(ox + 32, w), oy,
                                        min(oy + 32, h)))
    assert culled > 0
    np.testing.assert_array_equal(tiled.numpy(), full.numpy())


def _border_pixels(ctx, w, h):
    """SET_PIXEL / APPLY_PIXEL on the four sides of tile borders (31, 32,
    63, 64 ...), at the frame's last row and column, and just off the
    frame, and a rect whose NaN box touches nothing."""
    for x, y in ((31, 0), (32, 0), (31, 31), (32, 32), (63, 33), (64, 31),
                 (w - 1, h - 1), (w - 1, 0), (0, h - 1), (w, 5), (5, h),
                 (-1, 3)):
        ctx.set_pixel(x, y, 0.9, 0.1, 0.2, 0.6)
        ctx.apply_pixel(x, min(y + 1, h), 0.1, 0.8, 0.3, 0.5)
    ctx.draw_rect(10.0, 10.0, 5.0, 5.0, 0.2, 0.3, 0.4, 0.5)
    ctx._cmds.params[ctx._cmds.n - 1, 6] = math.nan


def _tiled_by_list(kinds, params, w, h, t_dtype, atlas):
    """The plain version applied tile by tile over the wrapper's list
    (touched_tiles; None: every tile), each tile with all the run's
    commands, as the kernel's blocks apply them."""
    p_np = params.numpy()
    tiles = tck.touched_tiles(kinds, p_np, w, h)
    ntx, nty = -(-w // 32), -(-h // 32)
    ids = range(ntx * nty) if tiles is None else tiles.tolist()
    out = torch.full((h, w, 4), 0.25, dtype=t_dtype)
    for t in ids:
        ox, oy = t % ntx * 32, t // ntx * 32
        tex.render_commands(out, kinds.tolist(), params, atlas,
                            window=(ox, min(ox + 32, w), oy,
                                    min(oy + 32, h)))
    return tiles, out


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("shape", [(256, 192), (100, 70)])
@pytest.mark.parametrize("scene", ["fractional", "border pixels", "empty",
                                   "textures"])
def test_k4_tile_list_is_the_union_and_covers_the_run(dt, shape, scene):
    """The K4 wrapper's host list of tiles (touched_tiles, the kernel's
    own test vectorised over the run in the fb's type) is the union of
    tiles_touched over the run, and the plain version applied over only
    those tiles equals the full-frame plain version; a FILL takes every
    tile (None) and a run that touches nothing lists no tile.  Texture
    blits are box kinds: their mask lies in their box."""
    w, h = shape
    ctx = JaxContext(w, h, True)
    if scene == "fractional":
        _fractional_boxes(ctx)
    elif scene == "border pixels":
        _border_pixels(ctx, w, h)
    elif scene == "textures":
        ctx.draw_line(3.0, 5.0, w - 4.0, 9.5, 2.5, 0.9, 0.9, 1.0, 0.8)
        _record_blits(ctx, _jax_textures(1))
        ctx.draw_rect(w - 30.5, 4.25, 12.0, 7.0, 0.2, 0.8, 0.4, 0.7)
    else:
        ctx.draw_rect(-50.0, -40.0, 20.0, 10.0, 1, 1, 1, 1)
        ctx.set_pixel(w + 40, 5, 1, 1, 1, 1)     # past the last tile
    kinds, params64 = (np.array(a) for a in ctx._cmds.snapshot())
    _, t_dtype = DTYPES[dt]
    params = torch.from_numpy(params64).to(t_dtype)
    atlas = _atlas(ctx, t_dtype)
    full = tex.render_commands(torch.full((h, w, 4), 0.25, dtype=t_dtype),
                               kinds.tolist(), params, atlas)
    tiles, tiled = _tiled_by_list(kinds, params, w, h, t_dtype, atlas)
    union = np.zeros((-(-h // 32), -(-w // 32)), bool)
    for k, q in zip(kinds.tolist(), params.numpy()):
        union |= tck.tiles_touched(k, q, w, h)
    if C.KIND_FILL in kinds.tolist():
        assert tiles is None
    else:
        np.testing.assert_array_equal(tiles, np.flatnonzero(union))
        assert tiles.dtype == np.int32
    if scene == "empty":
        assert tiles.size == 0
    else:
        assert 0 < union.sum() and (scene == "fractional"
                                    or not union.all())
    if scene == "textures":
        assert tck.TEXTURE_KINDS <= set(kinds.tolist())
        assert not torch.equal(tiled, torch.full_like(tiled, 0.25))
    np.testing.assert_array_equal(tiled.view(torch.int64 if dt == "f64"
                                             else torch.int32).numpy(),
                                  full.view(torch.int64 if dt == "f64"
                                            else torch.int32).numpy())


def test_k4_wrapper_refuses_a_wrong_host_copy():
    fb = torch.zeros(8, 8, 4, dtype=torch.float32)
    k = torch.tensor([C.KIND_RECT], dtype=torch.int32)
    p = torch.zeros(1, C.PARAM_W, dtype=torch.float32)
    # the host copy the tiles are listed from must be the params' own
    for bad in (np.zeros((1, C.PARAM_W), np.float64),
                np.zeros((2, C.PARAM_W), np.float32)):
        with pytest.raises(ValueError, match="host copy"):
            tck.render_span(fb, k, p, bad)
    tck.render_span(fb, k, p, p.numpy())
    assert tck.touched_tiles(np.array([C.KIND_FILL, C.KIND_RECT]),
                             np.zeros((2, C.PARAM_W), np.float32), 8,
                             8) is None


def test_k4_wrapper_needs_the_host_copy_off_the_cpu():
    """Off the CPU the tiles to launch are listed from the host copy of
    the params: without it the wrapper raises (it never reads the params
    back)."""
    fb = torch.zeros(8, 8, 4, dtype=torch.float32, device="meta")
    k = torch.tensor([C.KIND_RECT], dtype=torch.int32)
    p = torch.zeros(1, C.PARAM_W, dtype=torch.float32, device="meta")
    before = tck.render_span.launches
    with pytest.raises(ValueError, match="host_params are required"):
        tck.render_span(fb, k, p)
    assert tck.render_span.launches == before


@pytest.mark.parametrize("kinds,runs", [
    ([], []),
    ([C.KIND_TEX], [(0, 1)]),
    ([C.KIND_RECT], [(0, 1)]),
    ([C.KIND_FILL, C.KIND_NOOP, C.KIND_TEX, C.KIND_HITEFFECT, C.KIND_LINE,
      C.KIND_SPLIT_TEX], [(0, 3), (4, 6)]),
    ([C.KIND_TEX_FAST, C.KIND_SET_PIXEL, C.KIND_APPLY_PIXEL],
     [(0, 3)]),
    ([C.KIND_HITEFFECT], []),
    ([C.KIND_HITEFFECT, C.KIND_HITEFFECT, C.KIND_SPLIT_TEX,
      C.KIND_HITEFFECT], [(2, 3)]),
])
def test_arith_runs_are_maximal(kinds, runs):
    """The flush's K4 calls: every maximal run of the kinds K4 takes (the
    arithmetic kinds and the texture blits), a run of one included, and
    nothing for the hit effects."""
    assert tck.kernel_runs(kinds) == runs


def test_k4_wrapper_refuses_bad_inputs():
    fb = torch.zeros(8, 8, 4, dtype=torch.float32)
    k = torch.tensor([C.KIND_RECT], dtype=torch.int32)
    p = torch.zeros(1, C.PARAM_W, dtype=torch.float32)
    atlas = torch.zeros(4, 4, 4, dtype=torch.float32)
    for kind in (C.KIND_HITEFFECT, 13, -1):
        with pytest.raises(ValueError, match="not K4's kinds"):
            tck.render_span(fb, torch.tensor([kind], dtype=torch.int32), p,
                            atlas=atlas)
    with pytest.raises(ValueError, match="contiguous"):
        tck.render_span(torch.zeros(8, 8, 8)[..., ::2], k, p)
    with pytest.raises(TypeError):
        tck.render_span(fb.half(), k, p.half())
    with pytest.raises(TypeError):
        tck.render_span(fb, k, p.double())
    with pytest.raises(ValueError, match="on meta"):
        tck.render_span(fb, k, p.to("meta"))
    with pytest.raises(ValueError, match="host int32"):
        tck.render_span(fb, k.long(), p)
    with pytest.raises(ValueError, match="disagree"):
        tck.render_span(fb, k, torch.zeros(2, C.PARAM_W))
    # on the CPU the wrapper runs the plain version and launches nothing
    before = tck.render_span.launches
    tck.render_span(fb, k, p)
    assert tck.render_span.launches == before


@pytest.mark.parametrize("kind", sorted(tck.TEXTURE_KINDS))
def test_k4_wrapper_refuses_a_texture_run_without_its_atlas(kind):
    """A run holding a texture blit needs the atlas, in the frame's dtype,
    on its device, contiguous (AH, AW, 4); a run without one never reads
    it."""
    fb = torch.zeros(8, 8, 4, dtype=torch.float32)
    k = torch.tensor([C.KIND_RECT, kind], dtype=torch.int32)
    p = torch.zeros(2, C.PARAM_W, dtype=torch.float32)
    atlas = torch.zeros(4, 4, 4, dtype=torch.float32)
    before = tck.render_span.sampled
    with pytest.raises(ValueError, match="atlas is required"):
        tck.render_span(fb, k, p)
    with pytest.raises(TypeError, match="atlas is torch.float64"):
        tck.render_span(fb, k, p, atlas=atlas.double())
    with pytest.raises(ValueError, match="on meta"):
        tck.render_span(fb, k, p, atlas=atlas.to("meta"))
    for bad in (atlas[:, ::2], atlas[..., :3], atlas[0]):
        with pytest.raises(ValueError, match="contiguous"):
            tck.render_span(fb, k, p, atlas=bad)
    assert tck.render_span.sampled == before
    tck.render_span(fb, k[:1], p[:1], atlas=atlas.double())   # unread
    tck.render_span(fb, k, p, atlas=atlas)
    assert tck.render_span.sampled == before + 1


def _off_atlas(ctx, texs):
    """Blits whose texel index leaves the atlas: a region origin below
    the atlas (every texel NaN), one above it (a negative flat index,
    counted from the end) and one 2^32 / AW rows down, where v * AW
    wraps around int32 back into the atlas."""
    _record_blits(ctx, texs)
    n0 = ctx._cmds.n
    ah, aw = ctx._store.device.shape[:2]
    ctx.draw_texture(texs[0], 100.0, 20.0, 30.0, 30.0)
    ctx.rotate(0.3)
    ctx.draw_texture(texs[2], 150.0, 40.0, 40.0, 25.0)
    ctx.draw_splitted_texture(texs[1], 60.0, 100.0, 50.0, 30.0,
                              0.2, 0.8, 0.0, 1.0)
    p = ctx._cmds.params
    p[n0, 21] = ah + 3
    p[n0 + 1, 21] = -ah
    assert 2 ** 32 % aw == 0
    p[n0 + 2, 21] = 2 ** 32 // aw
    return n0


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("scene", ["blits", "mixed", "off atlas"])
def test_k4_texture_runs_match_jax_executor(dt, scene):
    """Runs of texture blits (TEX, TEX_FAST, SPLIT_TEX; rotated, scaled,
    partly off the frame; mixed with lines, rects and a circle; indices
    outside the atlas) through the port's K4 wrapper against the JAX
    package's executor, the path its flush takes for them."""
    np_dtype, t_dtype = DTYPES[dt]
    ctx = JaxContext(W, H, True)
    texs = _jax_textures(2)
    if scene == "mixed":
        ctx.draw_line(10.0, 20.0, 180.0, 150.0, 5.0, 0.9, 0.9, 0.1, 0.9)
        ctx.draw_rect(20.0, 10.0, 90.0, 50.0, 0.9, 0.1, 0.1, 0.8)
    if scene == "off atlas":
        n0 = _off_atlas(ctx, texs)
    else:
        _record_blits(ctx, texs)
    if scene == "mixed":
        ctx.rotate(0.4)
        ctx.draw_circle(80.0, 60.0, 35.0, 0.1, 0.9, 0.2, 0.6)
        ctx.draw_line(100.0, 30.0, 30.0, 140.0, 3.5, 0.2, 0.4, 0.9, 0.5)
    kinds, params = (np.array(a) for a in ctx._cmds.snapshot())
    assert tck.TEXTURE_KINDS <= set(kinds.tolist()) <= tck.KERNEL_KINDS
    atlas = np.array(ctx._store.device).astype(np_dtype)
    want = np.asarray(jex.render_command_list(
        jnp.full((H, W, 4), 0.25, np_dtype), jnp.asarray(kinds),
        jnp.asarray(params.astype(np_dtype)), jnp.asarray(atlas)))
    fb = torch.full((H, W, 4), 0.25, dtype=t_dtype)
    before = tck.render_span.sampled
    got = tck.render_span(fb, torch.from_numpy(kinds),
                          torch.from_numpy(params).to(t_dtype),
                          atlas=torch.from_numpy(atlas))
    assert got is fb
    assert tck.render_span.sampled - before == int(
        np.isin(kinds, sorted(tck.TEXTURE_KINDS)).sum())
    assert_matches_jax(got.numpy(), want)
    nan = np.isnan(got.numpy()).any(-1)
    np.testing.assert_array_equal(nan, np.isnan(want).any(-1))
    if scene == "off atlas":
        # the first is NaN wherever it draws, the other two read texels
        alone = torch.full((H, W, 4), 0.25, dtype=t_dtype)
        for i in (n0, n0 + 1, n0 + 2):
            one = tck.render_span(
                alone.clone(), torch.from_numpy(kinds[i:i + 1]),
                torch.from_numpy(params[i:i + 1]).to(t_dtype),
                atlas=torch.from_numpy(atlas))
            drawn = (one != alone).any(-1)
            assert drawn.any()
            assert bool(torch.isnan(one[drawn]).all()) == (i == n0)
    else:
        assert not nan.any()
