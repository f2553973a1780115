"""Kernel K1 of the PyTorch port (libnativecpurenderer_tpu_torch.ops.
tile_raster) against the JAX package's flat u8 tile kernel run in
interpret mode.

On the CPU the K1 wrapper runs its plain torch version (the CUDA kernel
itself is compared with it on the card by chip_smoke.py).  Fed JAX's own
prep, port and JAX frames are compared with these tolerances
(``assert_u8_close``):
  * sky mask (pixels no triangle covers): exact;
  * RGB: |delta| <= 1 u8 level, on at most 0.5 % of the pixels;
  * alpha (interpolated only when opaque=False): |delta| <= 1.  XLA:CPU's
    evaluation of the interpreted kernel body is not bit-stable (it may
    fuse a multiply and an add): interpolating a vertex alpha of 1.0
    lands a few ulps either side of 1.0 before the x255 truncation,
    giving 254 for 255 on up to ~10 % of the pixels.
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

torch.set_num_threads(1)

W, H = 64, 32
# bg alpha 0: a pixel is sky iff its alpha byte is 0 (mesh alpha is 1)
BG = np.array([0.12, 0.34, 0.56, 0.0], np.float32)


def assert_u8_close(got, want):
    """Port vs JAX u8 frames or tiles, (..., 4): see the module
    docstring for each tolerance and its reason.  The shares hold on the
    small scenes of these tests; at ``mesh_10k`` scale port and JAX
    differ on up to ~0.7 % of the pixels, bounded by their distances
    from the float64 oracle (``test_torch_mesh_scale.py``)."""
    got = np.asarray(got).astype(np.int16)
    want = np.asarray(want).astype(np.int16)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 3] == 0, want[..., 3] == 0,
                                  err_msg="sky mask")
    d = np.abs(got - want)
    assert d[..., :3].max() <= 1, d[..., :3].max()
    frac = (d[..., :3].max(-1) > 0).mean()
    assert frac <= 0.005, frac
    assert d[..., 3].max() <= 1


def _scene():
    """test_pallas_raster._scene as float32 numpy arrays."""
    verts, faces = mesh.icosphere(2)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    mvp = (mesh.perspective(1.0, W / H, 0.1, 10.0)
           @ mesh.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
           @ mesh.rotation_x(0.4))
    return (verts.astype(np.float32), faces.astype(np.int32),
            colors.astype(np.float32), mvp.astype(np.float32))


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _jax_prep_jit(v, f, c, m, tile_w, tile_h, capacity, span_x, span_y):
    tri = jr.setup_triangles(v, f, m, W, H)
    A, B, C, ia, sg, vl = jr.edge_coeffs(tri["sxy"], tri["z"], tri["valid"])
    sp, st, ct, ovf = jr.bin_triangles_flat(
        tri["sxy"], vl, W, H, tile_w, tile_h, capacity, span_x, span_y,
        edges=(A, B, C, sg))
    table = jp.build_table(A, B, C, tri["z"] * ia[:, None], ia, sg, vl,
                           c[f])
    return sp, st, ct, table, ovf


def _jax_prep(tile_w, tile_h, capacity, span_x=8, span_y=8):
    """JAX's per-frame prep of the _scene frame, as render_gouraud_pallas
    (flat=True) makes it: (sorted_pad, starts, counts, table)."""
    *prep, ovf = _jax_prep_jit(*(jnp.asarray(a) for a in _scene()), tile_w,
                               tile_h, capacity, span_x, span_y)
    assert not bool(ovf)
    return prep


def _both_kernels(prep, tile_w, tile_h, capacity, opaque, z_clip):
    sp, st, ct, table = prep
    want = jp.render_binned_pallas_flat_u8(
        sp, st, ct, table, jnp.asarray(BG), W, H, tile_w, tile_h, capacity,
        True, 32, opaque, z_clip, tiled=True)
    packed = tt.raster_tiles_flat_u8(
        *interop.prep_to_torch(sp, st, ct, table, "cpu"),
        tt.pack_bg(torch.from_numpy(BG)), W, tile_w, tile_h, opaque=opaque,
        z_clip=z_clip)
    return tt.tiles_u8(packed).numpy(), np.asarray(want)


@pytest.mark.parametrize("opaque,z_clip",
                         [(True, False), (False, True), (True, True)])
def test_k1_matches_jax_kernel_on_jax_prep(opaque, z_clip):
    # the kernel alone: JAX's sorted pairs, starts, counts and table
    # through both kernels, the whole tiled output compared (padded
    # slots included)
    prep = _jax_prep(32, 8, 96)
    got, want = _both_kernels(prep, 32, 8, 96, opaque, z_clip)
    assert got.shape == (8, 256, 4) and got.dtype == np.uint8
    assert_u8_close(got, want)
    assert (got[..., 3] == 0).mean() > 0.2 and (got[..., 3] > 0).mean() > 0.2


def test_k1_runs_straddling_blocks():
    # 8x8 tiles with capacity equal to the longest run: the JAX kernel's
    # two-block id window is as small as it can be and runs straddle its
    # block boundaries; the port walks each run straight from the array
    sp, st, ct, table = _jax_prep(8, 8, 4096, 3, 3)
    cap = int(np.asarray(ct).max())
    prep = _jax_prep(8, 8, cap, 3, 3)
    st, ct = np.asarray(prep[1]), np.asarray(prep[2])
    assert ((st // cap) != ((st + np.maximum(ct, 1) - 1) // cap)).any()
    got, want = _both_kernels(prep, 8, 8, cap, True, False)
    assert_u8_close(got, want)


def test_u8_matches_quantized_f32():
    # mirror of test_pallas_raster.test_u8_matches_quantized_f32: the
    # port's u8 frame == clip(rgba_f32 * 255, 0, 255) truncated of the
    # JAX f32 flat kernel (within the tolerance above), sky = packed bg
    v, f, c, m = _scene()
    kw = dict(tile_w=32, tile_h=8, capacity=96, span_x=8, span_y=8)
    fb, _, ovf = jr.render_gouraud_pallas(
        *(jnp.asarray(a) for a in (v, f, c)), W, H, jnp.asarray(m),
        bg=jnp.asarray(BG), interpret=True, flat=True, **kw)
    assert not bool(ovf)
    want = np.clip(np.asarray(fb) * 255.0, 0, 255).astype(np.uint8)
    got, ovf8 = tr.render_gouraud_u8(
        torch.from_numpy(v), torch.from_numpy(f.astype(np.int64)),
        torch.from_numpy(c), W, H, torch.from_numpy(m),
        bg=torch.from_numpy(BG), **kw)
    got = got.numpy()
    assert got.dtype == np.uint8 and not bool(ovf8)
    assert_u8_close(got, want)
    sky = got[..., 3] == 0
    assert sky.mean() > 0.2
    np.testing.assert_array_equal(got[sky],
                                  np.broadcast_to((BG * 255).astype(np.uint8),
                                                  got[sky].shape))


def _port_render(verts=None, **kw):
    v, f, c, m = _scene()
    v = v if verts is None else verts
    return tr.render_gouraud_u8(
        torch.from_numpy(v), torch.from_numpy(f.astype(np.int64)),
        torch.from_numpy(c), W, H, torch.from_numpy(m), tile_w=32,
        tile_h=8, capacity=96, span_x=8, span_y=8, **kw)


def test_u8_opaque_matches_u8():
    # mirror of test_pallas_raster.test_u8_opaque_matches_u8: the
    # alpha-free walk gives identical RGB and a = 255; interpolated
    # alpha may truncate to 254 where the weights round below 1.0
    a, _ = _port_render()
    b, _ = _port_render(opaque=True)
    a, b = a.numpy(), b.numpy()
    np.testing.assert_array_equal(a[..., :3], b[..., :3])
    assert (np.abs(a[..., 3].astype(int) - b[..., 3].astype(int))
            <= 1).all()
    assert set(np.unique(b[..., 3])) <= {0, 255}


def test_z_clip_skip_matches_and_guards():
    # mirror of test_pallas_raster.test_z_clip_skip_matches_and_guards:
    # in-frustum geometry renders identically without the per-pixel z
    # test; geometry outside [0, 1] z raises the overflow flag
    a, ovf_a = _port_render()
    b, ovf_b = _port_render(z_clip=False)
    assert not bool(ovf_a) and not bool(ovf_b)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    v_far = _scene()[0] * np.array([1, 1, 50], np.float32)
    _, ovf = _port_render(verts=v_far, z_clip=False)
    assert bool(ovf)


def test_pack_bg_and_detile_match_jax():
    bg = np.array([0.12, 0.34, 0.56, 1.0], np.float32)
    assert int(tt.pack_bg(torch.from_numpy(bg))[0]) == int(jp._pack_bg(bg))
    rng = np.random.default_rng(5)
    packed = rng.integers(-2 ** 31, 2 ** 31, (2 * 4, 32 * 8),
                          dtype=np.int64).astype(np.int32)
    want = jp._detile_packed(jnp.asarray(packed), 4, 2, 8, 32, 27, 64)
    got = tt.detile_packed(torch.from_numpy(packed), 64, 27, 32, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tt.tiles_u8(torch.from_numpy(packed)).numpy(),
        packed.view(np.uint8).reshape(8, 256, 4))


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    sp, st, ct, table = interop.prep_to_torch(*_jax_prep(32, 8, 96), "cpu")
    bgp = tt.pack_bg(torch.from_numpy(BG))
    before = tt.raster_tiles_flat_u8.launches
    tt.raster_tiles_flat_u8(sp, st, ct, table, bgp, W, 32, 8, opaque=True,
                            z_clip=False)
    # the CPU run is the plain version, not a kernel launch
    assert tt.raster_tiles_flat_u8.launches == before
    with pytest.raises(TypeError):
        tt.raster_tiles_flat_u8(sp.long(), st, ct, table, bgp, W, 32, 8,
                                opaque=True, z_clip=False)
    with pytest.raises(ValueError):
        tt.raster_tiles_flat_u8(sp, st, ct[:-1], table, bgp, W, 32, 8,
                                opaque=True, z_clip=False)
    with pytest.raises(ValueError):
        tt.raster_tiles_flat_u8(sp, st, ct, table[:, :16].contiguous(), bgp,
                                W, 32, 8, opaque=True, z_clip=False)
    with pytest.raises(ValueError):
        tt.raster_tiles_flat_u8(sp, st, ct, table, bgp, W, 128, 64,
                                opaque=True, z_clip=False)
    meta = [t.to("meta") for t in (sp, st, ct, table, bgp)]
    with pytest.raises(ValueError, match="no K1 kernel"):
        tt.raster_tiles_flat_u8(*meta, W, 32, 8, opaque=True, z_clip=False)
