"""The PyTorch port's float and depth Gouraud rasterizer against the JAX
package and against itself: ``render_gouraud`` (naive),
``render_gouraud_binned``, ``render_gouraud_pallas`` and its batch entry
on every route, near clipping, perspective-correct interpolation,
``render_textured_binned``, ``render_blended`` and BASELINE configs 1-3.
Mirrors of test_pallas_raster.py, test_raster3d.py, test_near_clip.py,
test_perspective.py, test_textured_raster.py and
test_baseline_configs.py, on the same seeded scenes; the JAX kernels run
in interpret mode and each JAX result is computed once.

On the CPU each kernel's wrapper runs its plain torch version.
Tolerances, each the JAX test's own unless said otherwise:
  * a route against another within the port: the JAX test's tolerance
    (K5 vs naive rgba 2e-5, z 1e-6; binned vs naive in float64 1e-9;
    near clip through K5, float32, vs binned float64 1e-5, z 1e-4);
    batch vs per frame and pre-gathered vs not: bit-equal;
  * port against JAX: the sky mask exact, the depth within 1 of 8191
    levels and equal on >= 99.5 % of the pixels (XLA:CPU fuses
    multiplies into adds, ROADMAP "Parity contracts"), rgba within the
    same route's JAX tolerance (2e-5 in float32, 1e-9 in float64) on at
    least 99.5 % of the pixels and within 1e-4 on the others (a knife-edge
    coverage or depth flip hands a pixel on a shared edge to the
    neighbouring triangle; measured 2.5e-5 on one pixel of the scene);
    u8 frames as test_torch_tile_raster's contract;
  * float64 oracles (``golden.raster_reference``): rgba 1e-9, z 1e-6;
    the config 1 golden PNG within 1 u8 level.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu.golden import raster_reference as gref
from libnativecpurenderer_tpu.models import mesh
from libnativecpurenderer_tpu.ops import raster3d as jr
from libnativecpurenderer_tpu_torch.ops import raster3d as tr
from test_torch_tile_raster import assert_u8_close

torch.set_num_threads(1)

W, H = 64, 32                 # test_pallas_raster's frame
KW = dict(tile_w=32, tile_h=8, capacity=96)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden_data")


def _t(dtype, verts, faces, *rest):
    """numpy arrays -> torch: faces int64, the rest in ``dtype`` (None
    passes through)."""
    out = [torch.tensor(np.asarray(verts), dtype=dtype),
           torch.tensor(np.asarray(faces), dtype=torch.int64)]
    return out + [None if a is None else torch.tensor(np.asarray(a),
                                                      dtype=dtype)
                  for a in rest]


def _j(dtype, verts, faces, *rest):
    """numpy arrays -> jax: faces int32, the rest in ``dtype``."""
    return ([jnp.asarray(verts, dtype), jnp.asarray(faces, jnp.int32)]
            + [None if a is None else jnp.asarray(a, dtype) for a in rest])


def _scene():
    """test_pallas_raster._scene as numpy: icosphere(2), 320 faces."""
    verts, faces = mesh.icosphere(2)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    mvp = (mesh.perspective(1.0, W / H, 0.1, 10.0)
           @ mesh.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
           @ mesh.rotation_x(0.4))
    return verts, faces, colors, mvp


def _mvps(angles):
    m = _scene()[3]
    return np.stack([m @ r for r in angles])


def assert_depth_rgba_close(rgba, z, want_rgba, want_z, atol):
    """Port vs JAX float frames: see the module docstring."""
    rgba, z = np.asarray(rgba), np.asarray(z)
    want_rgba, want_z = np.asarray(want_rgba), np.asarray(want_z)
    np.testing.assert_array_equal(z == 1.0, want_z == 1.0, err_msg="sky")
    dz = np.abs(np.rint(z.astype(np.float64) * tr.Z_LEVELS)
                - np.rint(want_z.astype(np.float64) * tr.Z_LEVELS))
    assert dz.max() <= 1
    assert (dz == 0).mean() >= 0.995
    off = (np.abs(rgba - want_rgba) > atol).any(-1)
    assert off.mean() <= 0.005
    np.testing.assert_allclose(rgba, want_rgba, atol=max(atol, 1e-4))


@functools.lru_cache(maxsize=None)
def _jax_scene(route):
    """The JAX package's frame of the scene on one route (interpreted
    kernels), as numpy."""
    v, f, c, m = _j(jnp.float32, *_scene())
    if route == "naive":
        out = jr.render_gouraud(v, f, c, W, H, m)
    elif route == "binned":
        out = jr.render_gouraud_binned(v, f, c, W, H, m, **KW)
    elif route == "pallas":
        out = jr.render_gouraud_pallas(v, f, c, W, H, m, interpret=True, **KW)
    elif route == "batch":
        out = jr.render_gouraud_pallas_batch(
            v, f, c, W, H, jnp.asarray(_mvps(_BATCH_ROT), jnp.float32),
            span_x=8, span_y=8, interpret=True, **KW)
    elif route == "batch_flat":
        out = jr.render_gouraud_pallas_batch(
            v, f, c, W, H, jnp.asarray(_mvps(_BATCH_ROT), jnp.float32),
            span_x=8, span_y=8, interpret=True, flat=True, **KW)
    return tuple(None if a is None else np.asarray(a) for a in out)


_BATCH_ROT = (np.eye(4), mesh.rotation_y(0.3), mesh.rotation_y(0.6))


def _port_scene(dtype=torch.float32):
    return _t(dtype, *_scene())


def test_pallas_matches_naive():
    v, f, c, m = _port_scene()
    fb_n, z_n = tr.render_gouraud(v, f, c, W, H, m)
    fb_p, z_p, ovf = tr.render_gouraud_pallas(v, f, c, W, H, m, **KW)
    assert not bool(ovf)
    assert fb_p.dtype == torch.float32 and fb_p.shape == (H, W, 4)
    np.testing.assert_allclose(fb_p.numpy(), fb_n.numpy(), atol=2e-5)
    np.testing.assert_allclose(z_p.numpy(), z_n.numpy(), atol=1e-6)
    assert_depth_rgba_close(fb_n, z_n, *_jax_scene("naive"), 2e-5)
    jfb, jz, jovf = _jax_scene("pallas")
    assert not bool(jovf)
    assert_depth_rgba_close(fb_p, z_p, jfb, jz, 2e-5)


def test_pallas_matches_binned_xla():
    v, f, c, m = _port_scene()
    fb_b, z_b, ovf_b = tr.render_gouraud_binned(v, f, c, W, H, m, **KW)
    fb_p, z_p, _ = tr.render_gouraud_pallas(v, f, c, W, H, m, **KW)
    assert not bool(ovf_b)
    np.testing.assert_allclose(fb_p.numpy(), fb_b.numpy(), atol=2e-5)
    np.testing.assert_allclose(z_p.numpy(), z_b.numpy(), atol=1e-6)
    jfb, jz, jovf = _jax_scene("binned")
    assert bool(jovf) == bool(ovf_b)
    assert_depth_rgba_close(fb_b, z_b, jfb, jz, 2e-5)


def test_flat_f32_route_matches_binned():
    # test_pallas_raster.test_flat_matches_binned_xla's scene part: the
    # K2a route against the fused binned route
    v, f, c, m = _port_scene()
    fb_b, z_b, _ = tr.render_gouraud_binned(v, f, c, W, H, m, **KW)
    fb_p, z_p, ovf = tr.render_gouraud_pallas(v, f, c, W, H, m, flat=True,
                                              **KW)
    assert not bool(ovf) and fb_p.dtype == torch.float32
    np.testing.assert_allclose(fb_p.numpy(), fb_b.numpy(), atol=2e-5)
    np.testing.assert_allclose(z_p.numpy(), z_b.numpy(), atol=1e-6)


def test_batched_matches_per_frame():
    v, f, c, _ = _port_scene()
    mvps = torch.tensor(_mvps(_BATCH_ROT), dtype=torch.float32)
    fb_b, z_b, ovf = tr.render_gouraud_pallas_batch(
        v, f, c, W, H, mvps, span_x=8, span_y=8, **KW)
    assert not bool(ovf) and fb_b.shape == (3, H, W, 4)
    jfb, jz, jovf = _jax_scene("batch")
    assert not bool(jovf)
    for i in range(3):
        fb_1, z_1, _ = tr.render_gouraud_pallas(v, f, c, W, H, mvps[i], **KW)
        assert torch.equal(fb_b[i], fb_1) and torch.equal(z_b[i], z_1)
        assert_depth_rgba_close(fb_b[i], z_b[i], jfb[i], jz[i], 2e-5)


def test_batched_flat_matches_per_frame():
    v, f, c, _ = _port_scene()
    mvps = torch.tensor(_mvps(_BATCH_ROT), dtype=torch.float32)
    fb_b, z_b, ovf = tr.render_gouraud_pallas_batch(
        v, f, c, W, H, mvps, span_x=8, span_y=8, flat=True, **KW)
    assert not bool(ovf)
    jfb, jz, _ = _jax_scene("batch_flat")
    for i in range(3):
        fb_1, z_1, _ = tr.render_gouraud_pallas(
            v, f, c, W, H, mvps[i], span_x=8, span_y=8, flat=True, **KW)
        assert torch.equal(fb_b[i], fb_1) and torch.equal(z_b[i], z_1)
        assert_depth_rgba_close(fb_b[i], z_b[i], jfb[i], jz[i], 2e-5)


def test_u8_batch_matches_per_frame():
    v, f, c, _ = _port_scene()
    rot = (np.eye(4), mesh.rotation_y(0.4))
    mvps = torch.tensor(_mvps(rot), dtype=torch.float32)
    kw = dict(span_x=8, span_y=8, flat=True, u8=True, **KW)
    fb_b, z_b, ovf = tr.render_gouraud_pallas_batch(v, f, c, W, H, mvps, **kw)
    assert z_b is None and not bool(ovf) and fb_b.dtype == torch.uint8
    jv, jf, jc, _ = _j(jnp.float32, *_scene())
    want = np.asarray(jr.render_gouraud_pallas_batch(
        jv, jf, jc, W, H, jnp.asarray(_mvps(rot), jnp.float32),
        interpret=True, **kw)[0])
    for i in range(2):
        fb_1, z_1, _ = tr.render_gouraud_pallas(v, f, c, W, H, mvps[i], **kw)
        assert z_1 is None and torch.equal(fb_b[i], fb_1)
        assert_u8_close(fb_b[i].numpy(), want[i])


_DYN_ROT = (np.eye(4), mesh.rotation_y(0.4), mesh.rotation_y(0.9),
            mesh.rotation_x(0.7))


@pytest.mark.parametrize("g", [1, 2, 4])
def test_dynrows_matches_flat_u8(g):
    # bit-exact against the flat u8 batch: the same pair runs in the same
    # order; g (the TPU kernel's frames a program) changes no value
    v, f, c, _ = _port_scene()
    mvps = torch.tensor(_mvps(_DYN_ROT), dtype=torch.float32)
    kw = dict(span_x=8, span_y=8, flat=True, u8=True, opaque=True,
              z_clip=False, **KW)
    ref, _, ovf0 = tr.render_gouraud_pallas_batch(v, f, c, W, H, mvps, **kw)
    got, z, ovf = tr.render_gouraud_pallas_batch(
        v, f, c, W, H, mvps, dynrows=g, rows_cap=2048, kcc=8, **kw)
    assert z is None and not bool(ovf) and not bool(ovf0)
    assert torch.equal(got, ref)
    if g == 1:
        got_r, _, ovf_r = tr.render_gouraud_pallas_batch(
            v, f, c, W, H, mvps, dynrows=1, rows_cap=65536, kcc=8, **kw)
        assert not bool(ovf_r) and torch.equal(got_r, ref)


def test_dynrows_overflow_flag():
    v, f, c, m = _port_scene()
    kw = dict(span_x=8, span_y=8, flat=True, u8=True, opaque=True,
              z_clip=False, dynrows=1, kcc=8, **KW)
    mvps = torch.stack([m, m])
    _, _, ovf = tr.render_gouraud_pallas_batch(v, f, c, W, H, mvps,
                                               rows_cap=256, **kw)
    assert bool(ovf)
    with pytest.raises(ValueError, match="opaque u8"):
        tr.render_gouraud_pallas_batch(v, f, c, W, H, mvps, **dict(
            kw, z_clip=True))


def test_pregathered_inputs_bit_exact_near_clip():
    # test_pallas_raster.test_pregathered_inputs_bit_exact's near_clip
    # case on the u8 route, and the same on the default (K5) route; the
    # u8 frame against JAX's
    v, f, c, m = _port_scene()
    pre = (tr.pregather_mesh(v, f), c[f])
    kw = dict(tile_w=32, tile_h=8, capacity=96, near_clip=True, kcc=8)
    for route in (dict(flat=True, u8=True), dict()):
        ref = tr.render_gouraud_pallas(v, f, c, W, H, m, **route, **kw)
        got = tr.render_gouraud_pallas(v, f, c, W, H, m, pre=pre, **route,
                                       **kw)
        for a, b in zip(ref[:2], got[:2]):
            assert (a is None and b is None) or torch.equal(a, b)
        assert not bool(ref[2]) and not bool(got[2])
    jv, jf, jc, jm = _j(jnp.float32, *_scene())
    want = jr.render_gouraud_pallas(jv, jf, jc, W, H, jm, interpret=True,
                                    flat=True, u8=True, **kw)[0]
    assert_u8_close(tr.render_gouraud_u8(v, f, c, W, H, m, tile_w=32,
                                         tile_h=8, capacity=96,
                                         near_clip=True)[0].numpy(),
                    np.asarray(want))


def test_random_cameras_match_naive():
    # test_flat_matches_naive_random_cameras's orbits: the K5 and K2a
    # routes against the port's naive render (the JAX test's tolerances),
    # and the naive render against JAX's
    v, f, c, _ = _port_scene()
    jv, jf, jc, _ = _j(jnp.float32, *_scene())
    rng = np.random.default_rng(3)
    compared = 0
    for _ in range(4):
        eye = rng.uniform(-1, 1, 3)
        eye = eye / np.linalg.norm(eye) * rng.uniform(1.8, 4.0)
        m = (mesh.perspective(rng.uniform(0.7, 1.4), W / H, 0.1, 10.0)
             @ mesh.look_at(eye, [0, 0, 0], [0, 1, 0]))
        mt = torch.tensor(m, dtype=torch.float32)
        fb_n, z_n = tr.render_gouraud(v, f, c, W, H, mt)
        assert_depth_rgba_close(fb_n, z_n, *jr.render_gouraud(
            jv, jf, jc, W, H, jnp.asarray(m, jnp.float32)), 2e-5)
        for flat in (False, True):
            fb_p, z_p, ovf = tr.render_gouraud_pallas(
                v, f, c, W, H, mt, span_x=4, span_y=6, flat=flat, **KW)
            if bool(ovf):
                continue
            compared += 1
            np.testing.assert_allclose(fb_p.numpy(), fb_n.numpy(),
                                       atol=2e-5)
            np.testing.assert_allclose(z_p.numpy(), z_n.numpy(), atol=1e-6)
    assert compared >= 4


def test_fuzz_scenes_match_binned():
    # test_flat_matches_binned_xla's fuzz scenes (random triangles, runs
    # straddling blocks): the K5 and K2a routes against the fused binned
    # route, the overflow flags equal to JAX's
    rng = np.random.default_rng(11)
    kw = dict(tile_w=32, tile_h=8, capacity=96, span_x=3, span_y=5)
    for _ in range(3):
        verts = rng.uniform(-1, 1, (50, 3))
        faces = rng.integers(0, 50, (30, 3))
        cols = rng.uniform(0, 1, (50, 4))
        v, f, c = _t(torch.float32, verts, faces, cols)
        ref = tr.render_gouraud_binned(v, f, c, W, H, **kw)
        jref = jr.render_gouraud_binned(*_j(jnp.float32, verts, faces, cols),
                                        W, H, jnp.eye(4, dtype=jnp.float32),
                                        **kw)
        assert bool(ref[2]) == bool(jref[2])
        for flat in (False, True):
            out = tr.render_gouraud_pallas(v, f, c, W, H, flat=flat, **kw)
            if not flat:
                assert bool(out[2]) == bool(ref[2])
            if not bool(out[2]):
                np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(),
                                           atol=2e-5)


def test_entry_route_errors():
    v, f, c, m = _port_scene()
    with pytest.raises(ValueError, match="flat=True"):
        tr.render_gouraud_pallas(v, f, c, W, H, m, u8=True)
    with pytest.raises(ValueError, match="tiled"):
        tr.render_gouraud_pallas(v, f, c, W, H, m, tiled=True)
    with pytest.raises(ValueError, match="flat=True"):
        tr.render_gouraud_pallas_batch(v, f, c, W, H, m[None], u8=True)


def test_band_rendering_matches_full_frame():
    # the y-band form render_gouraud takes for sharding: rows y0..y0+16
    # of the full frame, bit-equal within the port, close to JAX's band
    v, f, c, m = _port_scene()
    full, zf = tr.render_gouraud(v, f, c, W, H, m)
    band, zb = tr.render_gouraud(v, f, c, W, 16, m, band_height=16,
                                 full_height=H, y0=torch.tensor(8.0))
    assert torch.equal(band, full[8:24]) and torch.equal(zb, zf[8:24])
    jv, jf, jc, jm = _j(jnp.float32, *_scene())
    jb, jzb = jr.render_gouraud(jv, jf, jc, W, 16, jm, None, 16, H,
                                jnp.float32(8.0))
    assert_depth_rgba_close(band, zb, jb, jzb, 2e-5)


# --- test_raster3d.py: against the float64 NumPy oracle, 64x48 ---------

W2, H2 = 64, 48


def check_gouraud(verts, faces, colors, mvp=None):
    v, f, c, m = _t(torch.float64, verts, faces, colors, mvp)
    fb, z = tr.render_gouraud(v, f, c, W2, H2, m)
    gfb, gz = gref.render_gouraud(verts, faces, colors, W2, H2, mvp)
    np.testing.assert_allclose(fb.numpy(), gfb, atol=1e-9)
    np.testing.assert_allclose(z.numpy(), gz, atol=1e-6)
    jv, jf, jc, jm = _j(jnp.float64, verts, faces, colors, mvp)
    jfb, jz = jr.render_gouraud(jv, jf, jc, W2, H2, jm)
    assert_depth_rgba_close(fb, z, jfb, jz, 1e-9)
    return fb.numpy(), z.numpy()


def test_single_triangle_with_depth():
    verts = np.array([[-0.5, -0.5, 0.2], [0.7, -0.2, 0.2], [0.0, 0.8, 0.2]])
    faces = np.array([[0, 1, 2]])
    colors = np.tile([1.0, 0.25, 0.5, 1.0], (3, 1))
    fb, z = check_gouraud(verts, faces, colors)
    assert abs(fb[..., 0].max() - 1.0) < 1e-9
    assert (z < 1.0).any()


def test_depth_ordering_two_triangles():
    verts = np.array([
        [-0.8, -0.8, 0.7], [0.8, -0.8, 0.7], [0.0, 0.8, 0.7],
        [-0.6, -0.6, 0.3], [0.6, -0.6, 0.3], [0.0, 0.6, 0.3],
    ])
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    colors = np.array([[1, 0, 0, 1]] * 3 + [[0, 1, 0, 1]] * 3, np.float64)
    fb, _ = check_gouraud(verts, faces, colors)
    cy, cx = H2 // 2, W2 // 2
    assert abs(fb[cy, cx, 1] - 1.0) < 1e-9 and abs(fb[cy, cx, 0]) < 1e-9
    fb2, _ = check_gouraud(verts[::-1].copy(), np.array([[5, 4, 3],
                                                         [2, 1, 0]]),
                           colors[::-1].copy())
    np.testing.assert_array_equal(fb2, fb)


def test_gouraud_interpolation():
    verts = np.array([[-0.9, -0.9, 0.5], [0.9, -0.9, 0.5], [0.0, 0.9, 0.5]])
    faces = np.array([[0, 1, 2]])
    colors = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1]], np.float64)
    check_gouraud(verts, faces, colors)


def test_mesh_with_mvp():
    verts, faces = mesh.icosphere(1)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    mvp = (mesh.perspective(1.0, W2 / H2, 0.1, 10.0)
           @ mesh.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
           @ mesh.rotation_y(0.7))
    check_gouraud(verts, faces, colors, mvp)


def test_binned_matches_naive():
    verts, faces = mesh.icosphere(2)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    mvp = (mesh.perspective(1.0, W2 / H2, 0.1, 10.0)
           @ mesh.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
           @ mesh.rotation_x(0.4))
    v, f, c, m = _t(torch.float64, verts, faces, colors, mvp)
    fb_n, z_n = tr.render_gouraud(v, f, c, W2, H2, m)
    fb_b, z_b, ovf = tr.render_gouraud_binned(v, f, c, W2, H2, m, tile_w=16,
                                              tile_h=8, capacity=96)
    assert not bool(ovf) and fb_b.dtype == torch.float64
    np.testing.assert_allclose(fb_b.numpy(), fb_n.numpy(), atol=1e-9)
    np.testing.assert_allclose(z_b.numpy(), z_n.numpy(), atol=1e-9)
    jv, jf, jc, jm = _j(jnp.float64, verts, faces, colors, mvp)
    jfb, jz, _ = jr.render_gouraud_binned(jv, jf, jc, W2, H2, jm, tile_w=16,
                                          tile_h=8, capacity=96)
    assert_depth_rgba_close(fb_b, z_b, jfb, jz, 1e-9)


def test_bin_overflow_flag():
    verts = np.tile(np.array([[-0.1, -0.1, 0.5], [0.1, -0.1, 0.5],
                              [0.0, 0.1, 0.5]]), (60, 1))
    faces = np.arange(180).reshape(60, 3)
    v, f, c = _t(torch.float64, verts, faces, np.ones((180, 4)))
    _, _, ovf = tr.render_gouraud_binned(v, f, c, W2, H2, tile_w=16,
                                         tile_h=8, capacity=16)
    assert bool(ovf)


def _blended(verts, faces, uvs, tex, w, h, **kw):
    v, f, u, t = _t(torch.float64, verts, faces, uvs, tex)
    port = tr.render_blended(v, f, u, t, w, h, **{
        k: torch.as_tensor(a) for k, a in kw.items()}).numpy()
    want = np.asarray(jr.render_blended(
        *_j(jnp.float64, verts, faces, uvs, tex), w, h,
        **{k: jnp.asarray(a) for k, a in kw.items()}))
    np.testing.assert_allclose(port, want, atol=1e-9)
    return port


def test_blended_quads():
    verts, faces, uvs = mesh.quad_batch(3, seed=1)
    tex = np.zeros((8, 8, 4))
    tex[:, :, 0] = 1.0
    tex[:, :, 3] = 0.5
    fb = _blended(verts, faces, uvs, tex, W2, H2)
    assert fb[..., 0].max() > 0.4
    assert fb[..., 2].max() == 0.0
    assert fb[..., 3].max() <= 1.0


def test_blended_respects_opaque_depth():
    verts, faces, uvs = mesh.quad_batch(1, seed=2)
    fb = _blended(verts, faces, uvs, np.ones((4, 4, 4)), W2, H2,
                  opaque_depth=np.zeros((H2, W2)))
    assert fb.max() == 0.0


# --- test_near_clip.py: against the float64 clipping oracle, 64x48 -----

def _mvp_near():
    return (mesh.perspective(1.0, W2 / H2, 0.1, 10.0)
            @ mesh.look_at([0.0, 0.0, 2.0], [0, 0, 0], [0, 1, 0]))


def _near_binned(verts, faces, colors, mvp, **kw):
    v, f, c, m = _t(torch.float64, verts, faces, colors, mvp)
    fb, z, ovf = tr.render_gouraud_binned(v, f, c, W2, H2, m, tile_w=16,
                                          tile_h=8, capacity=96, **kw)
    assert not bool(ovf)
    return fb.numpy(), z.numpy()


def check_near(verts, faces, colors, mvp):
    fb, z = _near_binned(verts, faces, colors, mvp, near_clip=True)
    gfb, gz = gref.render_gouraud_clipped(verts, faces, colors, W2, H2, mvp)
    np.testing.assert_allclose(fb, gfb, atol=1e-9)
    np.testing.assert_allclose(z, gz, atol=1e-6)
    return fb, z


def _piercing_triangle():
    verts = np.array([[-0.5, -0.4, 0.0], [0.5, -0.4, 0.0], [0.0, 0.3, 4.0]])
    colors = np.array([[1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1]], np.float64)
    return verts, np.array([[0, 1, 2]]), colors


def test_one_vertex_behind_camera():
    verts, faces, colors = _piercing_triangle()
    fb, _ = check_near(verts, faces, colors, _mvp_near())
    assert fb[..., :3].max() > 0.1
    fb_cull, _ = _near_binned(verts, faces, colors, _mvp_near())
    assert fb_cull.max() == 0.0


def test_two_vertices_behind_camera():
    verts = np.array([[0.0, -0.2, 0.5], [-0.8, 0.3, 4.0], [0.8, 0.3, 4.0]])
    colors = np.array([[1, 1, 0, 1], [0, 1, 1, 1], [1, 0, 1, 1]], np.float64)
    fb, _ = check_near(verts, np.array([[0, 1, 2]]), colors, _mvp_near())
    assert fb[..., :3].max() > 0.1


def test_all_vertices_behind_camera():
    verts = np.array([[-0.5, -0.5, 5.0], [0.5, -0.5, 5.0], [0.0, 0.5, 6.0]])
    fb, _ = check_near(verts, np.array([[0, 1, 2]]), np.ones((3, 4)),
                       _mvp_near())
    assert fb.max() == 0.0


def test_mixed_mesh_with_piercing_quad():
    verts = np.array([
        [-0.9, -0.9, 1.0], [0.9, -0.9, 1.0], [0.0, 0.9, 1.0],
        [-0.4, -0.3, 0.5], [0.4, -0.3, 0.5],
        [-0.4, 0.3, 3.0], [0.4, 0.3, 3.0],
    ])
    faces = np.array([[0, 1, 2], [3, 4, 5], [4, 6, 5]])
    colors = np.array([[0.2, 0.2, 0.2, 1]] * 3 + [[1, 0, 0, 1], [0, 1, 0, 1],
                                                  [0, 0, 1, 1], [1, 1, 0, 1]],
                      np.float64)
    check_near(verts, faces, colors, _mvp_near())


def test_clip_pallas_interpret_matches_binned():
    # the default route (K5, float32 table) with near_clip against the
    # fused binned route in float64
    verts, faces, colors = _piercing_triangle()
    fb_b, z_b = _near_binned(verts, faces, colors, _mvp_near(),
                             near_clip=True)
    v, f, c, m = _t(torch.float64, verts, faces, colors, _mvp_near())
    fb_p, z_p, ovf = tr.render_gouraud_pallas(
        v, f, c, W2, H2, m, tile_w=16, tile_h=8, capacity=96, kcc=8,
        near_clip=True)
    assert not bool(ovf) and fb_p.dtype == torch.float64
    np.testing.assert_allclose(fb_p.numpy(), fb_b, atol=1e-5)
    np.testing.assert_allclose(z_p.numpy(), z_b, atol=1e-4)


def test_clip_preserves_fully_visible_scene():
    verts, faces = mesh.icosphere(1)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    mvp = (mesh.perspective(1.0, W2 / H2, 0.1, 10.0)
           @ mesh.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
           @ mesh.rotation_y(0.3))
    fb0, z0 = _near_binned(verts, faces, colors, mvp)
    fb1, z1 = _near_binned(verts, faces, colors, mvp, near_clip=True)
    np.testing.assert_allclose(fb0, fb1, atol=1e-12)
    np.testing.assert_allclose(z0, z1, atol=1e-12)


def test_clip_near_triangles_matches_jax():
    # the clipper alone on random clip-space triangles with 0-3 vertices
    # behind w = eps: slots, attributes and the valid mask
    rng = np.random.default_rng(7)
    clip = rng.uniform(-1, 1, (64, 3, 4))
    clip[..., 3] = rng.choice([-0.5, 1e-7, 0.3, 2.0], (64, 3))
    attrs = rng.uniform(0, 1, (64, 3, 4))
    got = tr.clip_near_triangles(torch.from_numpy(clip),
                                 torch.from_numpy(attrs))
    want = jr.clip_near_triangles(jnp.asarray(clip), jnp.asarray(attrs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    n_in = (clip[..., 3] > 1e-6).sum(1)
    assert set(n_in) == {0, 1, 2, 3}


# --- test_perspective.py, 64x64 ----------------------------------------

def _persp_scene():
    verts = np.array([[-1.0, -0.5, -1.0], [1.0, -0.5, -1.0],
                      [-1.0, -0.5, -6.0], [1.0, -0.5, -6.0]])
    faces = np.array([[0, 1, 2], [1, 3, 2]])
    colors = np.array([[0, 0, 0, 1], [0, 0, 0, 1], [1, 1, 1, 1],
                       [1, 1, 1, 1]], np.float64)
    return verts, faces, colors, mesh.perspective(1.2, 1.0, 0.1, 20.0)


def _persp_render(persp):
    v, f, c, m = _t(torch.float64, *_persp_scene())
    fb, z, ovf = tr.render_gouraud_binned(v, f, c, 64, 64, m, tile_w=32,
                                          tile_h=8, capacity=64,
                                          perspective_correct=persp)
    assert not bool(ovf)
    return fb.numpy(), z.numpy()


def test_perspective_differs_from_affine():
    affine, persp = _persp_render(False)[0], _persp_render(True)[0]
    cov = affine[..., 3] > 0
    assert cov.any()
    assert np.abs(affine[..., 0] - persp[..., 0])[cov].max() > 0.05
    jv, jf, jc, jm = _j(jnp.float64, *_persp_scene())
    jfb, jz, _ = jr.render_gouraud_binned(jv, jf, jc, 64, 64, jm, tile_w=32,
                                          tile_h=8, capacity=64,
                                          perspective_correct=True)
    assert_depth_rgba_close(persp, _persp_render(True)[1], jfb, jz, 1e-9)


def test_perspective_exact_midpoint():
    verts, _, _, proj = _persp_scene()
    persp = _persp_render(True)[0]
    clip = np.concatenate([verts, np.ones((4, 1))], 1) @ proj.T
    sy = (0.5 - clip[:, 1] / clip[:, 3] * 0.5) * 64
    y_mid = (sy[0] + sy[2]) / 2
    got = persp[int(round(y_mid)), 32, 0]
    a = (y_mid - sy[0]) / (sy[2] - sy[0])
    expect = (a / clip[2, 3]) / ((1 - a) / clip[0, 3] + a / clip[2, 3])
    assert abs(got - expect) < 0.03


def test_affine_matches_naive_unchanged():
    v, f, c, m = _t(torch.float64, *_persp_scene())
    fb_n, _ = tr.render_gouraud(v, f, c, 64, 64, m)
    np.testing.assert_allclose(_persp_render(False)[0], fb_n.numpy(),
                               atol=1e-9)


# --- render_textured_binned (test_textured_raster.py), 64x48 -----------

def _checker(n=8, size=32):
    tex = np.zeros((size, size, 4))
    ys, xs = np.mgrid[0:size, 0:size]
    tex[..., 0] = ((xs // (size // n) + ys // (size // n)) % 2)
    tex[..., 1] = 1.0 - tex[..., 0]
    tex[..., 3] = 1.0
    return tex


def _tex_binned(verts, faces, uvs, tex, mvp=None, **kw):
    v, f, u, t, m = _t(torch.float64, verts, faces, uvs, tex, mvp)
    fb, z, ovf = tr.render_textured_binned(v, f, u, t, W2, H2, m, tile_w=32,
                                           tile_h=8, capacity=16, **kw)
    assert not bool(ovf)
    return fb.numpy(), z.numpy()


def test_textured_quad_flat():
    verts = np.array([[-0.8, -0.8, 0.5], [0.8, -0.8, 0.5],
                      [-0.8, 0.8, 0.5], [0.8, 0.8, 0.5]])
    faces = np.array([[0, 1, 2], [1, 3, 2]])
    uvs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float64)
    for persp in (False, True):
        out, _ = _tex_binned(verts, faces, uvs, _checker(),
                             perspective_correct=persp)
        covered = out[..., 3] > 0
        assert covered.sum() > 0.4 * W2 * H2
        r = out[..., 0][covered]
        assert 0.35 < (r > 0.5).mean() < 0.65


def test_textured_depth_ordering():
    verts = np.array([
        [-0.9, -0.9, 0.8], [0.9, -0.9, 0.8], [-0.9, 0.9, 0.8],
        [0.9, 0.9, 0.8],
        [-0.4, -0.4, 0.2], [0.4, -0.4, 0.2], [-0.4, 0.4, 0.2],
        [0.4, 0.4, 0.2],
    ])
    faces = np.array([[0, 1, 2], [1, 3, 2], [4, 5, 6], [5, 7, 6]])
    uvs = np.zeros((8, 2))
    uvs[4:] = 0.99
    tex = np.zeros((4, 4, 4))
    tex[..., 2] = 1.0
    tex[..., 3] = 1.0
    tex[3, 3, 0] = 1.0
    tex[3, 3, 2] = 0.0
    out, _ = _tex_binned(verts, faces, uvs, tex)
    assert out[H2 // 2, W2 // 2, 0] == 1.0
    assert out[6, 6, 2] == 1.0


def test_perspective_texture_foreshortening():
    verts = np.array([[-1.0, -0.5, -1.0], [1.0, -0.5, -1.0],
                      [-1.0, -0.5, -8.0], [1.0, -0.5, -8.0]])
    faces = np.array([[0, 1, 2], [1, 3, 2]])
    uvs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float64)
    proj = mesh.perspective(1.2, W2 / H2, 0.1, 20.0)
    outs = {p: _tex_binned(verts, faces, uvs, _checker(8, 64), proj,
                           perspective_correct=p)[0] for p in (False, True)}
    assert np.abs(outs[True][..., 0] - outs[False][..., 0]).max() == 1.0


def test_textured_binned_matches_jax_and_k2a_route():
    # test_textured_pallas_matches_binned's scene: the fused route against
    # JAX's (texels equal on >= 99.5 % of the pixels, the JAX suite's
    # cross-route rule) and against the port's K2a route (render_textured)
    verts = np.array([[-0.8, -0.8, 0.5], [0.8, -0.8, 0.5],
                      [-0.8, 0.8, 0.5], [0.8, 0.8, 0.5],
                      [-0.3, -0.3, 0.2], [0.5, -0.2, 0.25]])
    faces = np.array([[0, 1, 2], [1, 3, 2], [3, 4, 5]])
    uvs = np.array([[0, 0], [1, 0], [0, 1], [1, 1], [0.3, 0.3], [0.7, 0.2]],
                   np.float64)
    tex = _checker(n=8, size=64)
    for persp in (False, True):
        a, za = _tex_binned(verts, faces, uvs, tex, perspective_correct=persp)
        jfb, jz, jovf = jr.render_textured_binned(
            *_j(jnp.float64, verts, faces, uvs, tex), W2, H2, tile_w=32,
            tile_h=8, capacity=16, perspective_correct=persp)
        assert not bool(jovf)
        jfb, jz = np.asarray(jfb), np.asarray(jz)
        np.testing.assert_array_equal(a[..., 3] > 0, jfb[..., 3] > 0)
        assert np.abs(np.rint(za * tr.Z_LEVELS)
                      - np.rint(jz * tr.Z_LEVELS)).max() <= 1
        assert (a == jfb).all(-1).mean() > 0.995
        v, f, u, t = _t(torch.float64, verts, faces, uvs, tex)
        b, zb, ovf = tr.render_textured(v, f, u, t, W2, H2, tile_w=32,
                                        tile_h=8, capacity=64, span_x=8,
                                        span_y=8, perspective_correct=persp)
        b = b.numpy()
        assert not bool(ovf)
        np.testing.assert_array_equal(a[..., 3] > 0, b[..., 3] > 0)
        np.testing.assert_array_equal(za, zb.numpy())
        assert (a == b).all(-1).mean() > 0.995


# --- test_baseline_configs.py ------------------------------------------

def test_config1_single_triangle_golden_png():
    from PIL import Image
    verts = np.array([[-0.6, -0.5, 0.3], [0.7, -0.3, 0.3], [0.05, 0.75, 0.3]])
    faces = np.array([[0, 1, 2]])
    colors = np.tile([0.9, 0.35, 0.2, 1.0], (3, 1))
    fb, z = tr.render_gouraud(*_t(torch.float64, verts, faces, colors), 512,
                              512)
    u8 = torch.clamp(fb * 255, 0, 255).to(torch.uint8).numpy()
    assert (z < 1.0).any()
    want = np.asarray(Image.open(os.path.join(GOLDEN_DIR,
                                              "config1_triangle.png")))
    assert np.abs(u8.astype(np.int16) - want.astype(np.int16)).max() <= 1


def _config2(tex, w, h):
    verts, faces, uvs = mesh.quad_batch(6, seed=3)
    faces = faces[np.argsort(-verts[faces[:, 0], 2], kind="stable")]
    out = _blended(verts, faces, uvs, tex, w, h)
    assert out.shape == (h, w, 4)
    assert out[..., :3].max() > 0.1
    assert out[..., 3].max() <= 1.0 + 1e-9
    blocked = _blended(verts, faces, uvs, tex, w, h,
                       opaque_depth=np.zeros((h, w)))
    assert np.abs(blocked).max() == 0.0


def test_config2_textured_quads_720p(ref_files):
    from PIL import Image
    img = np.asarray(Image.open(f"{ref_files}/image.png")).astype(np.float64)
    _config2(img / 255.0, 1280, 720)


def test_config2_textured_quads_seeded_texture():
    # config 2's scene and checks at 160x90 with a seeded RGBA texture
    # (the reference image is not in every checkout)
    _config2(np.random.default_rng(3).uniform(0, 1, (32, 48, 4)), 160, 90)


def test_config3_10k_mesh_sequence():
    verts, faces, colors = mesh.mesh_10k()
    assert len(faces) == 10000
    w, h = 128, 72
    mvp = (mesh.perspective(1.0, w / h, 0.1, 10.0)
           @ mesh.look_at([0.0, 0.6, 3.2], [0, 0, 0], [0, 1, 0])
           @ mesh.rotation_y(7 * 0.03))
    v, f, c, m = _t(torch.float64, verts, faces, colors, mvp)
    fb_b, _, ovf = tr.render_gouraud_binned(v, f, c, w, h, m, tile_w=32,
                                            tile_h=8, capacity=2048,
                                            batch_tiles=8)
    assert not bool(ovf)
    fb_n, _ = tr.render_gouraud(v, f, c, w, h, m)
    np.testing.assert_allclose(fb_b.numpy(), fb_n.numpy(), atol=1e-9)
    assert (fb_n[..., 3] > 0).float().mean() > 0.1
