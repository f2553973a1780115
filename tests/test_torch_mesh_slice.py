"""The PyTorch port's mesh -> u8 frame slice end to end, against the JAX
package and against itself.

Port vs JAX (render_gouraud_pallas(flat=True, u8=True, interpret=True),
render_gouraud_pallas_loop, the JAX MeshVideoPipeline) uses the
tolerance of test_torch_tile_raster.assert_u8_close — sky mask exact,
RGB within 1 level on at most 0.5 % of pixels, alpha within 1 level —
and equal overflow flags.  Within the port (loop vs per frame, tiled vs
detiled, pre= vs none, tiled vs plain sink) frames are bit-identical.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libnativecpurenderer_tpu.models import mesh
from libnativecpurenderer_tpu.ops import raster3d as jr
from libnativecpurenderer_tpu import pipeline as jpipe
from libnativecpurenderer_tpu_torch import MeshVideoPipeline
from libnativecpurenderer_tpu_torch.ops import raster3d as tr
from test_torch_tile_raster import assert_u8_close

torch.set_num_threads(1)

W, H = 64, 32
BG = np.array([0.12, 0.34, 0.56, 0.0], np.float32)   # sky iff alpha 0


def _sphere_cameras():
    """test_pallas_raster._scene and the four random orbit cameras of
    test_flat_matches_naive_random_cameras."""
    verts, faces = mesh.icosphere(2)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    cams = [mesh.perspective(1.0, W / H, 0.1, 10.0)
            @ mesh.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
            @ mesh.rotation_x(0.4)]
    rng = np.random.default_rng(3)
    for _ in range(4):
        eye = rng.uniform(-1, 1, 3)
        eye = eye / np.linalg.norm(eye) * rng.uniform(1.8, 4.0)
        cams.append(mesh.perspective(rng.uniform(0.7, 1.4), W / H, 0.1,
                                     10.0)
                    @ mesh.look_at(eye, [0, 0, 0], [0, 1, 0]))
    return (verts.astype(np.float32), faces.astype(np.int32),
            colors.astype(np.float32), [c.astype(np.float32) for c in cams])


def _gouraud_scene():
    """test_pipeline._gouraud_scene as float32 numpy arrays."""
    verts, faces, _ = mesh.quad_batch(12, seed=21)
    rng = np.random.default_rng(21)
    colors = rng.random((len(verts), 4))
    zmap = np.eye(4, dtype=np.float32)
    zmap[2, 2] = 0.25
    zmap[2, 3] = 0.5
    rot = (zmap @ mesh.rotation_y(0.6) @ mesh.rotation_x(0.3)).astype(
        np.float32)
    mvps = np.stack([zmap, rot, (zmap @ mesh.rotation_y(1.1)).astype(
        np.float32)])
    return (verts.astype(np.float32), faces.astype(np.int32),
            colors.astype(np.float32), mvps)


def _t(verts, faces, colors):
    return (torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)),
            torch.from_numpy(colors))


_KW = dict(tile_w=32, tile_h=8, capacity=96, span_x=4, span_y=6)


@pytest.mark.parametrize("cam", range(5))
def test_render_matches_jax(cam):
    # capacity 128 holds every camera's runs (96 overflows camera 3), so
    # each of the 5 cameras compares its pixels; flagged overflow parity
    # is tested on the binning (test_torch_raster3d)
    v, f, c, cams = _sphere_cameras()
    m = cams[cam]
    kw = dict(_KW, capacity=128)
    want, _, ovf_j = jr.render_gouraud_pallas(
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(c), W, H,
        jnp.asarray(m), bg=jnp.asarray(BG), interpret=True, flat=True,
        u8=True, **kw)
    got, ovf = tr.render_gouraud_u8(*_t(v, f, c), W, H, torch.from_numpy(m),
                                    bg=torch.from_numpy(BG), **kw)
    assert not bool(ovf) and not bool(ovf_j)
    assert got.shape == (H, W, 4) and got.dtype == torch.uint8
    assert_u8_close(got.numpy(), np.asarray(want))


_LOOP_KW = dict(tile_w=32, tile_h=8, capacity=512, span_x=8, span_y=8)


@pytest.mark.parametrize("tiled", [False, True])
def test_loop_matches_jax_loop(tiled):
    W2, H2 = 70, 50
    v, f, c, mvps = _gouraud_scene()
    want, ovf_j = jr.render_gouraud_pallas_loop(
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(c), W2, H2,
        jnp.asarray(mvps), interpret=True, mega=0, tiled=tiled, **_LOOP_KW)
    got, ovf = tr.render_gouraud_u8_loop(*_t(v, f, c), W2, H2,
                                         torch.from_numpy(mvps),
                                         tiled=tiled, **_LOOP_KW)
    assert not bool(ovf_j) and not bool(ovf)
    assert got.shape == tuple(np.asarray(want).shape)
    # production defaults: opaque, so alpha is 255 or the (0) bg alpha
    assert_u8_close(got.numpy(), np.asarray(want))


def test_loop_matches_per_frame_and_tiled_layout():
    # mirror of test_pipeline.test_gouraud_loop_matches_per_frame, within
    # the port: the loop with hoisted gathers == per-frame renders, and
    # its tiled layout detiles to the same frames
    W2, H2 = 70, 50
    v, f, c, mvps = _gouraud_scene()
    vt, ft, ct = _t(v, f, c)
    got, ovf = tr.render_gouraud_u8_loop(vt, ft, ct, W2, H2,
                                         torch.from_numpy(mvps), **_LOOP_KW)
    tiles, ovf_t = tr.render_gouraud_u8_loop(vt, ft, ct, W2, H2,
                                             torch.from_numpy(mvps),
                                             tiled=True, **_LOOP_KW)
    assert not bool(ovf) and not bool(ovf_t)
    for i in range(mvps.shape[0]):
        one, ovf1 = tr.render_gouraud_u8(
            vt, ft, ct, W2, H2, torch.from_numpy(mvps[i]), opaque=True,
            z_clip=False, **_LOOP_KW)
        assert not bool(ovf1)
        np.testing.assert_array_equal(got[i].numpy(), one.numpy())
        np.testing.assert_array_equal(
            tr.detile_u8_host(tiles[i], W2, H2, 32, 8), one.numpy())


def test_tiled_matches_detiled_with_viewport_crop():
    # mirror of test_pallas_raster.test_u8_tiled_matches_detiled: H = 27
    # does not divide tile_h = 8; padded slots carry real rasterised
    # values, and the viewport mask makes the checksums agree
    v, f, c, cams = _sphere_cameras()
    Hp = 27
    bg = torch.tensor([0.12, 0.34, 0.56, 1.0])
    kw = dict(tile_w=32, tile_h=8, capacity=96, span_x=8, span_y=8, bg=bg)
    m = torch.from_numpy(cams[0])
    fb8, ovf = tr.render_gouraud_u8(*_t(v, f, c), W, Hp, m, **kw)
    tiles, ovf_t = tr.render_gouraud_u8(*_t(v, f, c), W, Hp, m, tiled=True,
                                        **kw)
    assert bool(ovf) == bool(ovf_t)
    assert tiles.shape == (2 * 4, 32 * 8, 4) and tiles.dtype == torch.uint8
    np.testing.assert_array_equal(tr.detile_u8_host(tiles, W, Hp, 32, 8),
                                  fb8.numpy())
    msk = tr.viewport_mask(W, Hp, 32, 8).numpy()
    assert not msk.all()
    assert (int((tiles.numpy() * msk[..., None]).sum())
            == int(fb8.numpy().astype(np.int64).sum()))


def test_pregathered_inputs_bit_exact():
    # mirror of test_pallas_raster.test_pregathered_inputs_bit_exact
    v, f, c, cams = _sphere_cameras()
    vt, ft, ct = _t(v, f, c)
    pre = (tr.pregather_mesh(vt, ft), ct[ft])
    for cam in cams[:3]:
        m = torch.from_numpy(cam)
        for kw in (dict(opaque=True, z_clip=False), dict()):
            ref = tr.render_gouraud_u8(vt, ft, ct, W, H, m, **_KW, **kw)
            got = tr.render_gouraud_u8(vt, ft, ct, W, H, m, pre=pre, **_KW,
                                       **kw)
            np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
            assert bool(got[1]) == bool(ref[1])


class _PlainSink:
    def __init__(self):
        self.frames = []

    def put_frame_u8(self, u8):
        self.frames.append(np.asarray(u8).copy())


class _TiledSink(_PlainSink):
    def __init__(self):
        super().__init__()
        self.tiled = []

    def put_frame_tiled_u8(self, tiles, w, h, tw, th):
        self.tiled.append(np.asarray(tiles).copy())
        self.frames.append(tr.detile_u8_host(tiles, w, h, tw, th))


def test_pipeline_tiled_and_plain_sinks_match_and_match_jax():
    # the port's MeshVideoPipeline feeds tiled frames to a tiled sink and
    # raster frames to a plain one, identical content both ways, with a
    # batch remainder (3 frames, batch 2); the JAX pipeline's frames agree
    # within tolerance
    W2, H2 = 70, 50
    v, f, c, mvps = _gouraud_scene()
    tiled, plain = _TiledSink(), _PlainSink()
    for sink in (tiled, plain):
        pipe = MeshVideoPipeline(sink, W2, H2, v, f, colors=c, batch=2,
                                 device="cpu", **_LOOP_KW)
        assert pipe._tiled == (sink is tiled)
        for m in mvps:
            pipe.submit(m)
        pipe.finish()
    assert len(tiled.tiled) == len(plain.frames) == mvps.shape[0]
    for a, b in zip(tiled.frames, plain.frames):
        np.testing.assert_array_equal(a, b)
    jax_sink = _PlainSink()
    jp = jpipe.MeshVideoPipeline(jax_sink, W2, H2, v, f, colors=c, batch=2,
                                 interpret=True, mega=0, tiled=False,
                                 **_LOOP_KW)
    for m in mvps:
        jp.submit(m)
    jp.finish()
    for a, b in zip(plain.frames, jax_sink.frames):
        assert_u8_close(a, b)


def test_pipeline_overflow_raises():
    # mirror of test_pipeline.test_mesh_video_pipeline_overflow_raises
    W2, H2 = 70, 50
    v, f, c, mvps = _gouraud_scene()
    kw = dict(_LOOP_KW, capacity=8, span_x=1, span_y=1)
    pipe = MeshVideoPipeline(_TiledSink(), W2, H2, v, f, colors=c, batch=4,
                             device="cpu", **kw)
    for m in mvps:
        pipe.submit(m)
    with pytest.raises(ValueError, match="overflow"):
        pipe.finish()
