"""Kernels K1-wf and K1-mxu of the PyTorch port and the ``wf=`` and
``mxu=`` routes of its u8 Gouraud and textured entries, against the JAX
package run in interpret mode (each JAX result computed once per module)
and against the port's own default walk, on test_pallas_raster's scene
(64x32, tiles 32x8, capacity 96) and test_textured_raster's quads.

On the CPU each wrapper runs its plain torch version (the CUDA kernels
are compared with them on the card by chip_smoke.py).  Tolerances:
  * ``clamp_mega``: JAX's cases, exact;
  * ``build_table_mxu`` against JAX's: NaN rows in the same places and
    every other value bit-equal (measured: 0 ulp; the three-term sums
    are written out in JAX's left-to-right order);
  * ``wf=n`` against ``wf=0``: bit-equal (the walk is K1's); against
    JAX's ``wf=n`` frames: K1's u8 contract (``assert_u8_close``);
  * the ``mxu=1`` plain walk against JAX's ``mxu=1`` kernel, fed JAX's
    prep and the port's: K1's u8 contract (measured: opaque frames equal,
    the others differ in interpolated alpha by 1 only, as K1's do);
  * ``mxu=1`` against the port's own default walk: JAX's budget
    (test_pallas_raster.test_u8_mxu_walk_matches), at most 15 % of the
    pixels differing and 0.2 % by more than one level; batch frames
    bit-equal to single frames;
  * ``mxu=2``: its bfloat16 rounding bit-equal to a NumPy
    round-to-nearest-even of the float32 bits, and its walk bit-equal to
    the ``mxu=1`` walk over the NumPy-rounded table (the frame's pixel
    coordinates, below 256, are exact in bfloat16).  On the CPU JAX's
    ``mxu=2`` equals its ``mxu=1`` (XLA ignores the precision), so it is
    not compared with JAX;
  * textured ``mxu=1`` against JAX's ``render_textured_pallas_batch
    (mxu=1)``: JAX's textured mxu contract (hit masks equal, at least
    99 % of the pixels the same texel), perspective-correct and affine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu.models import mesh
from libnativecpurenderer_tpu.ops import pallas_raster as jp
from libnativecpurenderer_tpu.ops import raster3d as jr
from libnativecpurenderer_tpu_torch import interop
from libnativecpurenderer_tpu_torch.ops import raster3d as tr
from libnativecpurenderer_tpu_torch.ops import tile_raster as tt
from test_torch_tile_raster import BG, H, W, _scene, assert_u8_close

torch.set_num_threads(1)

KW = dict(tile_w=32, tile_h=8, capacity=96, span_x=8, span_y=8)
NT = (W // 32) * (H // 8)           # 8 tiles
MXU_SHARE, MXU_BIG_SHARE = 0.15, 0.002


def _u8_diff(a, b):
    """(share of pixels differing, share differing by more than 1 level)
    between two u8 frames."""
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    d = d.max(-1)
    return float((d > 0).mean()), float((d > 1).mean())


def _port_inputs():
    v, f, c, m = _scene()
    t = interop.mesh_to_torch(v, f, c, "cpu")
    return t + (torch.from_numpy(m),)


def _port_u8(opaque=False, z_clip=True, **kw):
    v, f, c, m = _port_inputs()
    frame, ovf = tr.render_gouraud_u8(v, f, c, W, H, m,
                                      bg=torch.from_numpy(BG), opaque=opaque,
                                      z_clip=z_clip, **KW, **kw)
    assert not bool(ovf)
    return frame.numpy()


@functools.lru_cache(maxsize=None)
def _jax_u8(opaque=False, z_clip=True, wf=0, mxu=0):
    """JAX's render_gouraud_pallas(flat, u8) frame of the scene, the kernel
    interpreted."""
    v, f, c, m = (jnp.asarray(a) for a in _scene())
    frame, _, ovf = jr.render_gouraud_pallas(
        v, f, c, W, H, m, bg=jnp.asarray(BG), interpret=True, flat=True,
        u8=True, opaque=opaque, z_clip=z_clip, wf=wf, mxu=mxu, **KW)
    assert not bool(ovf)
    return np.asarray(frame)


@functools.lru_cache(maxsize=None)
def _jax_edges():
    """JAX's edge setup of the scene: (A, B, C, zsc, inv_area, sign,
    valid, attrs) as numpy."""
    v, f, c, m = (jnp.asarray(a) for a in _scene())
    tri = jr.setup_triangles(v, f, m, W, H)
    A, B, C, ia, sg, vl = jr.edge_coeffs(tri["sxy"], tri["z"], tri["valid"])
    return tuple(np.asarray(a) for a in (A, B, C, tri["z"] * ia[:, None],
                                         ia, sg, vl, c[f]))


@functools.lru_cache(maxsize=None)
def _jax_mxu_prep():
    """JAX's flat binning of the scene and its mxu table, as numpy."""
    v, f, c, m = (jnp.asarray(a) for a in _scene())
    tri = jr.setup_triangles(v, f, m, W, H)
    A, B, C, ia, sg, vl = jr.edge_coeffs(tri["sxy"], tri["z"], tri["valid"])
    sp, st, ct, ovf = jr.bin_triangles_flat(
        tri["sxy"], vl, W, H, 32, 8, 96, 8, 8, edges=(A, B, C, sg))
    assert not bool(ovf)
    table = jp.build_table_mxu(*(jnp.asarray(a) for a in _jax_edges()))
    return tuple(np.asarray(a) for a in (sp, st, ct, table))


@functools.lru_cache(maxsize=None)
def _jax_mxu_kernel(opaque):
    """JAX's mxu=1 u8 kernel on its own mxu prep, tiled (NT, P, 4)."""
    sp, st, ct, table = (jnp.asarray(a) for a in _jax_mxu_prep())
    return np.asarray(jp.render_binned_pallas_flat_u8(
        sp, st, ct, table, jnp.asarray(BG), W, H, 32, 8, 96, True, 32,
        opaque, True, False, 1, tiled=True))


@pytest.mark.parametrize("mega,nt,want", [
    (0, 12, 0), (8, 12, 6), (8, 8, 8), (5, 12, 4), (7, 13, 1), (64, 12, 12),
    (-3, 12, 0)])
def test_clamp_mega(mega, nt, want):
    # mirror of test_pallas_raster.test_clamp_mega's cases
    assert tr.clamp_mega(mega, nt) == want == jr.clamp_mega(mega, nt)


def test_build_table_mxu_matches_jax():
    # every 7th triangle marked invalid: NaN rows beside the pad row
    edges = [np.array(a) for a in _jax_edges()]
    edges[6][::7] = False
    want = np.asarray(jp.build_table_mxu(*(jnp.asarray(a) for a in edges)))
    got = tt.build_table_mxu(*(torch.from_numpy(a) for a in edges)).numpy()
    assert got.shape == want.shape == (edges[0].shape[0] + 1, tt.ROW_W)
    assert got.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan.all(1).sum() > 1 and not nan[:-1].all()   # invalid + pad row
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
    # lanes 4q + 3 are zero on every valid row
    assert not got[~nan.all(1)][:, 3::4].any()


@pytest.mark.parametrize("wf", [1, 2, NT, 3])
def test_wf_equals_grid_walk_and_jax(wf):
    # 3 does not divide NT: both entries clamp it to 2
    base = _port_u8()
    got = _port_u8(wf=wf)
    np.testing.assert_array_equal(got, base)
    assert_u8_close(got, _jax_u8(wf=wf))
    np.testing.assert_array_equal(_jax_u8(wf=wf), _jax_u8())


def test_wf_wrapper_takes_frames_and_mxu():
    # B frames in one persistent launch are K1's B frames; with an affine
    # table the persistent launch walks K1-mxu's walk
    v, f, c, m = _port_inputs()
    pre = (tr.pregather_mesh(v, f), c[f])
    mvps = [m, m @ torch.from_numpy(mesh.rotation_y(0.3).astype(np.float32))]
    for mxu in (0, 1, 2):
        preps = [tr.prepare_frame(v, f, c, W, H, mv, bg=torch.from_numpy(BG),
                                  pre=pre, mxu=mxu, **KW) for mv in mvps]
        args = tuple(torch.stack([p[k] for p in preps]) for k in
                     ("sorted_pad", "starts", "counts", "table"))
        args += (preps[0]["packed_bg"], W, 32, 8)
        kw = dict(opaque=False, z_clip=True)
        if mxu:
            want = tt.raster_tiles_flat_u8_mxu(*args, mxu=mxu, **kw)
        else:
            want = tt.raster_tiles_flat_u8(*args, **kw)
        for wf in (1, 5):
            got = tt.raster_tiles_flat_u8_wf(*args, wf=wf, mxu=mxu, **kw)
            assert got.shape == (2, NT, 256)
            assert torch.equal(got, want)


@pytest.mark.parametrize("opaque", [True, False])
def test_mxu_matches_jax_on_jax_prep(opaque):
    sp, st, ct, table = interop.kernel_inputs_to_torch("cpu",
                                                       *_jax_mxu_prep())
    packed = tt.raster_tiles_flat_u8_mxu(
        sp, st, ct, table, tt.pack_bg(torch.from_numpy(BG)), W, 32, 8,
        opaque=opaque, z_clip=True, mxu=1)
    got = tt.tiles_u8(packed).numpy()
    want = _jax_mxu_kernel(opaque)
    assert got.shape == want.shape == (NT, 256, 4)
    assert_u8_close(got, want)


@pytest.mark.parametrize("opaque", [True, False])
def test_mxu_matches_jax_on_port_prep(opaque):
    got = _port_u8(opaque=opaque, mxu=1)
    assert_u8_close(got, _jax_u8(opaque=opaque, mxu=1))
    assert (got[..., 3] == 0).mean() > 0.2 and (got[..., 3] > 0).mean() > 0.2


@pytest.mark.parametrize("opaque", [True, False])
def test_mxu_within_budget_of_fma_walk(opaque):
    # JAX's own budget of its mxu walk against the FMA walk
    mx = _port_u8(opaque=opaque, mxu=1)
    base = _port_u8(opaque=opaque)
    np.testing.assert_array_equal(mx[..., 3] == 0, base[..., 3] == 0)
    share, big = _u8_diff(mx, base)
    assert share <= MXU_SHARE and big <= MXU_BIG_SHARE, (share, big)


@pytest.mark.parametrize("mxu", [1, 2])
def test_mxu_batch_equals_single_frames(mxu):
    v, f, c, m = _port_inputs()
    rot = torch.from_numpy(mesh.rotation_y(0.4).astype(np.float32))
    mvps = torch.stack([m, m @ rot])
    kw = dict(flat=True, u8=True, bg=torch.from_numpy(BG), mxu=mxu, **KW)
    frames, _, ovf = tr.render_gouraud_pallas_batch(v, f, c, W, H, mvps,
                                                    **kw)
    assert not bool(ovf)
    for i in range(2):
        one, _, _ = tr.render_gouraud_pallas(v, f, c, W, H, mvps[i], **kw)
        assert torch.equal(frames[i], one)


def _bf16_rne(a):
    """NumPy round-to-nearest-even of float32 bits to bfloat16, as
    float32; NaN stays NaN."""
    a = np.asarray(a, np.float32)
    b = a.view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    out = r.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(a), a, out)


def test_mxu2_bf16_rounding_is_round_to_nearest_even():
    rng = np.random.default_rng(5)
    vals = [rng.standard_normal(4096).astype(np.float32)
            * np.float32(2.0) ** rng.integers(-130, 120, 4096),
            np.arange(65536, dtype=np.float32),        # pixel coordinates
            _jax_mxu_prep()[3].ravel()]
    # ties either way: low 16 bits exactly 0x8000, bit 16 even and odd
    ties = (rng.integers(0, 1 << 15, 512, dtype=np.uint32) << 17) | 0x8000
    vals.append(np.concatenate([ties, ties | 0x10000]).view(np.float32))
    vals.append(np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45,
                          -1e-40, np.finfo(np.float32).max,
                          np.finfo(np.float32).tiny], np.float32))
    for a in vals:
        got = tt.bf16_round(torch.from_numpy(np.array(a))).numpy()
        want = _bf16_rne(a)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        np.testing.assert_array_equal(got[fin].view(np.uint32),
                                      want[fin].view(np.uint32))


@pytest.mark.parametrize("opaque", [True, False])
def test_mxu2_walk_is_mxu1_on_the_rounded_table(opaque):
    # the frame's coordinates are below 256, exact in bfloat16, so mxu=2
    # differs from mxu=1 only by the table's rounding
    assert (np.arange(256, dtype=np.float32) == _bf16_rne(
        np.arange(256, dtype=np.float32))).all()
    sp, st, ct, table = interop.kernel_inputs_to_torch("cpu",
                                                       *_jax_mxu_prep())
    bgp = tt.pack_bg(torch.from_numpy(BG))
    rounded = torch.from_numpy(_bf16_rne(table.numpy()))
    kw = dict(opaque=opaque, z_clip=True)
    two = tt.raster_tiles_flat_u8_mxu(sp, st, ct, table, bgp, W, 32, 8,
                                      mxu=2, **kw)
    one = tt.raster_tiles_flat_u8_mxu(sp, st, ct, rounded, bgp, W, 32, 8,
                                      mxu=1, **kw)
    assert torch.equal(two, one)
    assert not torch.equal(two, tt.raster_tiles_flat_u8_mxu(
        sp, st, ct, table, bgp, W, 32, 8, mxu=1, **kw))


def _quads():
    verts, faces, uvs = mesh.quad_batch(12, seed=3)
    tex = np.random.default_rng(11).integers(0, 256, (32, 32, 4), np.uint8)
    return (verts.astype(np.float32), faces.astype(np.int32),
            uvs.astype(np.float32), tex)


TEX_KW = dict(tile_w=32, tile_h=8, capacity=64, span_x=8, span_y=8)


@functools.lru_cache(maxsize=None)
def _jax_tex(persp):
    """JAX's render_textured_pallas_batch(mxu=1) of test_textured_raster's
    quads, two frames, interpreted."""
    v, f, u, tex = _quads()
    mvp = np.eye(4, dtype=np.float32)
    fb, ovf = jr.render_textured_pallas_batch(
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(u), jnp.asarray(tex), W,
        H, jnp.asarray(np.stack([mvp, mvp])), interpret=True,
        perspective_correct=persp, mxu=1, **TEX_KW)
    assert not bool(ovf)
    return np.asarray(fb)


@pytest.mark.parametrize("persp", [True, False],
                         ids=["perspective", "affine"])
def test_tex_mxu_matches_jax(persp):
    v, f, u, tex = interop.textured_mesh_to_torch(*_quads(), "cpu")
    mvps = torch.eye(4)[None].expand(2, 4, 4)
    kw = dict(perspective_correct=persp, **TEX_KW)
    got, ovf = tr.render_textured_u8_batch(v, f, u, tex, W, H, mvps, mxu=1,
                                           **kw)
    assert not bool(ovf) and got.shape == (2, H, W, 4)
    got = got.numpy()
    np.testing.assert_array_equal(got[0], got[1])
    for want in (_jax_tex(persp)[0],
                 tr.render_textured_u8_batch(v, f, u, tex, W, H, mvps,
                                             **kw)[0][0].numpy()):
        np.testing.assert_array_equal(got[0][..., 3] > 0, want[..., 3] > 0)
        same = (got[0] == want).all(-1)
        assert same.mean() > 0.99, same.mean()
    assert (got[0][..., 3] > 0).mean() > 0.2


def test_wrappers_on_cpu_count_no_launch(monkeypatch):
    sp, st, ct, table = interop.kernel_inputs_to_torch("cpu",
                                                       *_jax_mxu_prep())
    bgp = tt.pack_bg(torch.from_numpy(BG))
    tex = torch.arange(64 * 64, dtype=torch.int32)
    wrappers = (tt.raster_tiles_flat_u8_wf, tt.raster_tiles_flat_u8_mxu,
                tt.raster_tiles_tex_u8_mxu)
    before = [w.launches for w in wrappers]
    tt.raster_tiles_flat_u8_wf(sp, st, ct, table, bgp, W, 32, 8, opaque=True,
                               z_clip=True, wf=2, mxu=1)
    tt.raster_tiles_flat_u8_mxu(sp, st, ct, table, bgp, W, 32, 8,
                                opaque=True, z_clip=True, mxu=1)
    tt.raster_tiles_tex_u8_mxu(sp, st, ct, table, tex, (64, 64), bgp, W, 32,
                               8, z_clip=True, mxu=1)
    assert [w.launches for w in wrappers] == before
    # a device with no kernel, and bad knob values, raise
    meta = [t.to("meta") for t in (sp, st, ct, table, bgp)]
    with pytest.raises(ValueError, match="no K1-wf kernel"):
        tt.raster_tiles_flat_u8_wf(*meta, W, 32, 8, opaque=True, z_clip=True,
                                   wf=2)
    with pytest.raises(ValueError, match="no K1-mxu kernel"):
        tt.raster_tiles_flat_u8_mxu(*meta, W, 32, 8, opaque=True,
                                    z_clip=True, mxu=1)
    for bad in (dict(wf=0), dict(wf=2, mxu=3)):
        with pytest.raises(ValueError):
            tt.raster_tiles_flat_u8_wf(sp, st, ct, table, bgp, W, 32, 8,
                                       opaque=True, z_clip=True, **bad)
    with pytest.raises(ValueError, match="mxu must be"):
        _port_u8(mxu=3)
    # a cuda device without a card raises, never runs on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        interop.kernel_inputs_to_torch("cuda", *_jax_mxu_prep())
