"""The PyTorch port's textured mesh path (kernels K3, K2b, K2a, the
textured entries and the textured MeshVideoPipeline) against the JAX
package and against itself, at 64x48 on the JAX suite's scenes
(``mesh.quad_batch``, tiles 32x8, span 8x8).

On the CPU each kernel's wrapper runs its plain torch version (the CUDA
kernels are compared with them on the card by chip_smoke.py).  The JAX
textured kernels run in interpret mode, as the JAX suite runs them, and
each JAX result is computed once per module.  XLA:CPU may fuse a multiply
and an add in the interpreted kernel and in the prep (ROADMAP "Parity
contracts"), so port and JAX are held to this contract:
  * sky masks (pixels no triangle covers): exact;
  * texel index (ui, vi): equal on at least 99.5 % of the covered pixels
    and within 1 elsewhere (the JAX suite's own cross-route tolerance,
    test_textured_raster.py:123,157); measured: equal on every pixel of
    these scenes, the crafted rows included;
  * where the index agrees, the packed texel equal bit for bit;
  * K2a: the key's z part within 1 level (measured: 1 level on 0.03 % of
    the pixels) and its slot bits exact wherever the z part agrees; the
    attributes within 4 ulp (measured: 1.75e-7 relative, 1.5 ulp);
  * the per-frame prep: sorted pairs, runs and overflow flag exact, the
    row table within 4 ulp (measured: 2 ulp, in the C and scaled
    attribute columns).
Within the port (loop vs batch, tiled vs detiled, per-frame vs loop)
frames are bit-identical.
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
import libnativecpurenderer_tpu_torch as port
from libnativecpurenderer_tpu_torch import interop
from libnativecpurenderer_tpu_torch.ops import raster3d as tr
from libnativecpurenderer_tpu_torch.ops import tile_raster as tt
from libnativecpurenderer_tpu_torch.testing import crafted_uv_table

torch.set_num_threads(1)

W, H = 64, 48
TILE = dict(tile_w=32, tile_h=8, span_x=8, span_y=8)
CAP = 64
TEX_DIMS = (24, 40)     # (th, tw): not square, not a power of two wide
ULP4 = 4 * 2.0 ** -23   # 4 ulp, relative


def _quads():
    verts, faces, uvs = mesh.quad_batch(12, seed=3)
    return (verts.astype(np.float32), faces.astype(np.int32),
            uvs.astype(np.float32))


def _camera():
    """A perspective view of the quads from the side: w varies over each
    quad, so perspective-correct and affine interpolation differ."""
    return (mesh.perspective(1.1, W / H, 0.1, 10.0)
            @ mesh.look_at([0.8, 0.5, 1.6], [0, 0, 0.5], [0, 1, 0])
            ).astype(np.float32)


def _tex(dims, seed):
    return np.random.default_rng(seed).integers(0, 256, dims + (4,),
                                                np.uint8)


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_tex_prep(v, f, u, m, persp):
    return jr._tex_prep(v, f, u[f], m, W, H, TILE["tile_w"], TILE["tile_h"],
                        CAP, TILE["span_x"], TILE["span_y"], persp, 0,
                        z_clip=True)


@pytest.fixture(scope="module", params=[True, False],
                ids=["perspective", "affine"])
def jax_kernels(request):
    """JAX's prep of the quads under _camera(), and the JAX kernels' outputs
    on it: K3 (raster_tiles_tex + _tex_resolve_finish), K2b (tex_dims
    branch), K2a (f32 branch), and K2b on the crafted table."""
    persp = request.param
    v, f, u = (jnp.asarray(a) for a in _quads())
    sp, st, cn, tb, ovf = _jax_tex_prep(v, f, u, jnp.asarray(_camera()),
                                        persp)
    assert not bool(ovf)
    th, tw = TEX_DIMS
    tex_u8 = _tex(TEX_DIMS, 4)
    bpr = (tw + 127) // 128
    tex_l = jnp.pad(jr.pack_texture_u8(jnp.asarray(tex_u8)).reshape(th, tw),
                    ((0, 0), (0, bpr * 128 - tw))).reshape(th * bpr, 128)
    kw = dict(tex_split=True, z_clip=True, tex_skip=True)
    pk, fb = jp.render_binned_tex_resolve_batch(
        sp[None], st[None], cn[None], tb[None], tex_l,
        jnp.zeros(4, jnp.float32), W, H, 32, 8, CAP, TEX_DIMS, True, 32, 14,
        detile=False, **kw)
    k3 = jr._tex_resolve_finish(pk, fb, tex_l, th, tw, bpr, 1024, 2, 6, 8,
                                32, H, W)[0]
    crafted = jnp.asarray(crafted_uv_table(torch.from_numpy(
        np.array(tb))).numpy())
    idx, idx_crafted = (
        jp.render_binned_tex_idx_batch(sp[None], st[None], cn[None],
                                       t[None], W, H, 32, 8, CAP, TEX_DIMS,
                                       True, 32)[0]
        for t in (tb, crafted))
    keys, rgba = jp.render_binned_pallas_flat(
        sp, st, cn, tb, jnp.zeros(4, jnp.float32), W, H, 32, 8, CAP, True, 32)
    return {"persp": persp, "prep": (sp, st, cn, tb), "crafted": crafted,
            "tex_u8": tex_u8, "k3": np.asarray(k3), "idx": np.asarray(idx),
            "idx_crafted": np.asarray(idx_crafted), "keys": np.asarray(keys),
            "rgba": np.asarray(rgba),
            "unresolved": int((np.asarray(fb) >= 0).sum())}


def _port_prep(jk, table=None):
    sp, st, cn, tb = jk["prep"]
    return interop.prep_to_torch(sp, st, cn, tb if table is None else table,
                                 "cpu")


def _port_idx(jk, table=None):
    sp, st, cn, tb = _port_prep(jk, table)
    return tt.render_binned_tex_idx_batch(
        sp[None], st[None], cn[None], tb[None], W, H, 32, 8,
        TEX_DIMS)[0].numpy()


def assert_index_close(got, want):
    """Texel indices (..., -1 for sky): sky exact, (ui, vi) equal on
    >= 99.5 % of the covered pixels and within 1 elsewhere."""
    tw = TEX_DIMS[1]
    np.testing.assert_array_equal(got < 0, want < 0, err_msg="sky mask")
    hit = want >= 0
    assert hit.mean() > 0.2
    assert (got == want)[hit].mean() >= 0.995
    assert np.abs(got % tw - want % tw)[hit].max() <= 1
    assert np.abs(got // tw - want // tw)[hit].max() <= 1


def test_k2b_matches_jax_kernel(jax_kernels):
    assert_index_close(_port_idx(jax_kernels), jax_kernels["idx"])


def test_k2b_crafted_uv_rows_match_jax_kernel(jax_kernels):
    # huge, negative, tiny or zero denominators and NaN: the port's
    # saturating conversion (raster3d._to_i32) against XLA's
    got = _port_idx(jax_kernels, jax_kernels["crafted"])
    want = jax_kernels["idx_crafted"]
    assert_index_close(got, want)
    assert len(np.unique(want)) > 100          # the rows spread


def test_k2b_batch_entry_is_one_launch(jax_kernels, monkeypatch):
    # render_binned_tex_idx_batch hands its B frames to K2b in one call
    # with a leading B, as JAX's entry does; each frame equals the
    # per-frame loop bit for bit and JAX's entry within the contract
    jk = jax_kernels
    frames = [_port_prep(jk), _port_prep(jk, jk["crafted"])]
    sp, st, cn, tb = (torch.stack([f[i] for f in frames]) for i in range(4))
    k2b, calls = tt.raster_tiles_tex_idx, []

    def spy(*args, **kw):
        calls.append(tuple(args[2].shape))
        return k2b(*args, **kw)

    monkeypatch.setattr(tt, "raster_tiles_tex_idx", spy)
    got = tt.render_binned_tex_idx_batch(sp, st, cn, tb, W, H, 32, 8,
                                         TEX_DIMS)
    assert calls == [(2, 2 * 6)]
    assert got.shape == (2, H, W) and got.dtype == torch.int32
    loop = torch.stack([tt._detile_plane(
        k2b(*f, TEX_DIMS, W, 32, 8, z_clip=True), W, H, 32, 8)
        for f in frames])
    assert torch.equal(got, loop)
    for frame, want in zip(got.numpy(), (jk["idx"], jk["idx_crafted"])):
        assert_index_close(frame, want)


def test_k3_matches_jax_kernel(jax_kernels):
    jk = jax_kernels
    sp, st, cn, tb = _port_prep(jk)
    tex = tr.pack_texture_u8(torch.from_numpy(jk["tex_u8"]))
    packed = tt.raster_tiles_tex_u8(sp, st, cn, tb, tex, TEX_DIMS,
                                    tt.pack_bg(torch.zeros(4)), W, 32, 8,
                                    z_clip=True)
    assert packed.shape == (2 * 6, 32 * 8) and packed.dtype == torch.int32
    got = tt.detile_packed(packed, W, H, 32, 8).numpy()
    want = jk["k3"]
    # the JAX kernel left pixels to its fallback gather: the port fetches
    # them in the kernel
    assert jk["unresolved"] > 0
    idx_p, idx_j = _port_idx(jk), jk["idx"]
    sky = idx_j < 0
    assert not got[sky].any() and not want[sky].any()       # bg 0
    same = (got == want).all(-1)
    agree = idx_p == idx_j
    assert same[agree].all()
    assert same[~sky].mean() >= 0.995
    texels = jk["tex_u8"].reshape(-1, 4)
    np.testing.assert_array_equal(got[~sky], texels[idx_p[~sky]])


def test_k2a_matches_jax_kernel(jax_kernels):
    jk = jax_kernels
    keys, rgba = (a.numpy() for a in tt.render_binned_pallas_flat(
        *_port_prep(jk), torch.zeros(4), W, H, 32, 8))
    assert keys.shape == (H, W) and rgba.shape == (H, W, 4)
    assert keys.dtype == np.int32 and rgba.dtype == np.float32
    want_k, want_r = jk["keys"], jk["rgba"]
    sky = want_k == tr.SKY_KEY
    np.testing.assert_array_equal(keys == tr.SKY_KEY, sky)
    zp, zj = keys >> tr.IDX_BITS, want_k >> tr.IDX_BITS
    assert np.abs(zp - zj).max() <= 1
    z_same = zp == zj
    assert z_same.mean() >= 0.995
    np.testing.assert_array_equal((keys & tr.IDX_MASK)[z_same],
                                  (want_k & tr.IDX_MASK)[z_same])
    assert not rgba[sky].any()
    np.testing.assert_allclose(rgba, want_r, rtol=ULP4, atol=ULP4)


def test_k2a_wrapper_tiled_outputs_and_detile(jax_kernels):
    # the raw K2a layout: (NT, P) keys, (NT, 4, P) rgba with 0 for sky;
    # detile_keys_rgba against JAX's _detile on the port's own tiles
    sp, st, cn, tb = _port_prep(jax_kernels)
    keys, rgba = tt.raster_tiles_keys_f32(sp, st, cn, tb, W, 32, 8,
                                          z_clip=True)
    assert keys.shape == (12, 256) and rgba.shape == (12, 4, 256)
    sky = keys == tr.SKY_KEY
    assert not rgba.transpose(1, 2)[sky].any()
    bg = np.array([0.25, 0.5, 0.75, 1.0], np.float32)
    want = jp._detile(jnp.asarray(keys.numpy()), jnp.asarray(rgba.numpy()),
                      6, 2, 8, 32, H - 5, W, bg, jnp.float64)
    got = tt.detile_keys_rgba(keys, rgba, W, H - 5, 32, 8,
                              torch.from_numpy(bg), torch.float64)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_textured_prep_matches_jax(jax_kernels):
    jk = jax_kernels
    vt, ft, ut, _ = interop.textured_mesh_to_torch(
        *_quads(), jk["tex_u8"], "cpu")
    # the float entries' table (float32 edge constants, as JAX forms them)
    prep = tr.prepare_textured_frame(
        vt, ft, ut[ft], W, H, torch.from_numpy(_camera()), capacity=CAP,
        perspective_correct=jk["persp"], z_clip=True, exact_c=False, **TILE)
    for name, want in zip(("sorted_pad", "starts", "counts"), jk["prep"]):
        np.testing.assert_array_equal(prep[name].numpy(), np.asarray(want),
                                      err_msg=name)
    assert not bool(prep["overflow"])
    np.testing.assert_allclose(prep["table"].numpy(),
                               np.asarray(jk["prep"][3]), rtol=ULP4,
                               atol=0.0, equal_nan=True)


def test_pack_texture_and_textured_mesh_match_jax():
    tex_u8 = _tex((5, 7), 1)
    np.testing.assert_array_equal(
        tr.pack_texture_u8(torch.from_numpy(tex_u8)).numpy(),
        np.asarray(jr.pack_texture_u8(jnp.asarray(tex_u8))))
    v, f, u, t = interop.textured_mesh_to_torch(*_quads(), tex_u8, "cpu")
    assert (v.dtype, f.dtype, u.dtype, t.dtype) == (
        torch.float32, torch.int64, torch.float32, torch.uint8)
    assert u.shape == (v.shape[0], 2) and t.shape == (5, 7, 4)
    with pytest.raises(ValueError):
        tr.pack_texture_u8(torch.from_numpy(tex_u8).float())
    with pytest.raises(ValueError):
        interop.textured_mesh_to_torch(*_quads(), tex_u8[..., :3], "cpu")


# ------------------------------------------------------------------ #
# mirrors of tests/test_textured_raster.py and test_pipeline.py
# ------------------------------------------------------------------ #

def _t(verts, faces, uvs, tex_u8):
    return interop.textured_mesh_to_torch(verts, faces, uvs, tex_u8, "cpu")


@pytest.fixture(scope="module")
def idx_batch_scene():
    """test_tex_idx_batch_matches_single's scene and JAX's two routes on
    it, for both interpolations."""
    rng = np.random.default_rng(3)
    verts, faces, uvs = mesh.quad_batch(12, seed=3)
    tex_u8 = rng.integers(0, 256, (32, 32, 4), np.uint8)
    mvp = np.eye(4, dtype=np.float32)
    args = (jnp.asarray(verts, jnp.float32), jnp.asarray(faces, jnp.int32),
            jnp.asarray(uvs, jnp.float32))
    kw = dict(capacity=64, **TILE)
    jax_out = {}
    for persp in (False, True):
        fb_a, z_a, _ = jr.render_textured_pallas(
            *args, jnp.asarray(tex_u8, jnp.float32), W, H, interpret=True,
            perspective_correct=persp, **kw)
        fb_b, _ = jr.render_textured_pallas_batch(
            *args, jnp.asarray(tex_u8), W, H, jnp.asarray(mvp[None]),
            interpret=True, perspective_correct=persp, **kw)
        jax_out[persp] = (np.asarray(fb_a), np.asarray(z_a),
                          np.asarray(fb_b)[0])
    return verts, faces, uvs, tex_u8, mvp, kw, jax_out


@pytest.mark.parametrize("persp", [False, True])
def test_tex_idx_batch_matches_single(idx_batch_scene, persp):
    # mirror: render_textured (K2a + the per-pixel fetch, f32 texture of
    # u8 values) against render_textured_u8_batch (K3): identical hit
    # masks, the same texel on >= 99.5 % of pixels, identical batch
    # frames; and each route against its JAX counterpart
    verts, faces, uvs, tex_u8, mvp, kw, jax_out = idx_batch_scene
    v, f, u, tex = _t(verts, faces, uvs, tex_u8)
    m = torch.from_numpy(mvp)
    fb_a, z_a, ovf_a = tr.render_textured(
        v, f, u, tex.float(), W, H, m, perspective_correct=persp, **kw)
    fb_b, ovf_b = tr.render_textured_u8_batch(
        v, f, u, tex, W, H, torch.stack([m, m]), perspective_correct=persp,
        **kw)
    assert not bool(ovf_a) and not bool(ovf_b)
    a, b = fb_a.numpy(), fb_b.numpy()
    assert a.dtype == np.float32 and b.dtype == np.uint8
    np.testing.assert_array_equal(b[0], b[1])
    np.testing.assert_array_equal(a[..., 3] > 0, b[0][..., 3] > 0)
    same = (a.astype(np.int32) == b[0].astype(np.int32)).all(-1)
    assert same.mean() > 0.995, same.mean()
    ja, jz, jb = jax_out[persp]
    for got, want in ((a, ja), (b[0], jb)):
        np.testing.assert_array_equal(got[..., 3] > 0, want[..., 3] > 0)
        same = (got.astype(np.int32) == want.astype(np.int32)).all(-1)
        assert same.mean() > 0.995, same.mean()
    assert np.abs(z_a.numpy() - jz).max() <= 1.0 / tr.Z_LEVELS + 1e-12


def test_tex_fused_loop_matches_batch():
    # mirror: the loop entry == the batch entry, bit-exact, and both ==
    # per-frame renders
    rng = np.random.default_rng(3)
    verts, faces, uvs = mesh.quad_batch(12, seed=3)
    tex_u8 = rng.integers(0, 256, (32, 32, 4), np.uint8)
    v, f, u, tex = _t(verts, faces, uvs, tex_u8)
    mvps = torch.stack([torch.eye(4), torch.from_numpy(
        (mesh.rotation_y(0.6) @ mesh.rotation_x(0.3)).astype(np.float32)),
        torch.eye(4)])
    kw = dict(capacity=512, **TILE)
    base, ovf = tr.render_textured_u8_batch(v, f, u, tex, W, H, mvps, **kw)
    got, ovf_l = tr.render_textured_u8_loop(v, f, u, tex, W, H, mvps, **kw)
    assert bool(ovf) == bool(ovf_l)
    np.testing.assert_array_equal(got.numpy(), base.numpy())
    for i in range(mvps.shape[0]):
        one, _ = tr.render_textured_u8(v, f, u, tex, W, H, mvps[i], **kw)
        np.testing.assert_array_equal(one.numpy(), got[i].numpy())


def _f64_texels(verts, faces, uvs, tex_u8, hit):
    """float64 evaluation of the clamped-nearest fetch at the covered
    pixels of a screen-parallel mesh (identity camera, so w = 1 and
    perspective-correct = affine): the snapped vertices' barycentric
    weights at each integer pixel, the first face in order winning (they
    lie at one depth, and the lower slot wins a tie)."""
    from libnativecpurenderer_tpu.golden.raster_reference import project
    hh, ww = hit.shape
    sx, sy, _, _ = project(np.asarray(verts, np.float64), np.eye(4), ww, hh)
    sx, sy = np.round(sx * 256) / 256, np.round(sy * 256) / 256
    py, px = np.mgrid[0:hh, 0:ww].astype(np.float64)
    th, tw = tex_u8.shape[:2]
    out = np.zeros((hh, ww, 4), np.uint8)
    done = ~hit
    for i0, i1, i2 in faces:
        x0, y0, x1, y1, x2, y2 = (sx[i0], sy[i0], sx[i1], sy[i1], sx[i2],
                                  sy[i2])
        a2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        w0 = ((y1 - y2) * px + (x2 - x1) * py + (x1 * y2 - x2 * y1)) / a2
        w1 = ((y2 - y0) * px + (x0 - x2) * py + (x2 * y0 - x0 * y2)) / a2
        w2 = ((y0 - y1) * px + (x1 - x0) * py + (x0 * y1 - x1 * y0)) / a2
        cov = ~done & (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        u = w0 * uvs[i0, 0] + w1 * uvs[i1, 0] + w2 * uvs[i2, 0]
        v = w0 * uvs[i0, 1] + w1 * uvs[i1, 1] + w2 * uvs[i2, 1]
        ui = np.clip(np.trunc(u * tw), 0, tw - 1).astype(int)
        vi = np.clip(np.trunc(v * th), 0, th - 1).astype(int)
        out[cov] = tex_u8[vi[cov], ui[cov]]
        done |= cov
    assert done.all()
    return out


def test_tex_resolve_footprint_fallback():
    # mirror: the quad whose v sweeps a 256-row texture within a few
    # tiles sends most of JAX's pixels to its fallback gather; the port
    # fetches every texel in K3.  Hit masks equal.  The port equals a
    # float64 evaluation of the fetch on every covered pixel; the JAX
    # route is one texel row away from it on ~1 % of them (measured
    # 0.94 %): at ~6 texel rows a pixel, XLA:CPU's fused multiply-adds in
    # the interpreted kernel move v * 256 across a row boundary.
    rng = np.random.default_rng(5)
    verts = np.array([[-0.9, -0.9, 0.5], [0.9, -0.9, 0.5],
                      [-0.9, 0.9, 0.5], [0.9, 0.9, 0.5]], np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    uvs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
    tex_u8 = rng.integers(0, 256, (256, 32, 4), np.uint8)
    mvp = np.eye(4, dtype=np.float32)
    kw = dict(capacity=16, perspective_correct=True, **TILE)
    want, ovf_j = jr.render_textured_pallas_batch(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(uvs),
        jnp.asarray(tex_u8), W, H, jnp.asarray(mvp[None]), interpret=True,
        **kw)
    got, ovf = tr.render_textured_u8_batch(*_t(verts, faces, uvs, tex_u8),
                                           W, H, torch.from_numpy(mvp[None]),
                                           **kw)
    assert not bool(ovf) and not bool(ovf_j)
    a, b = got.numpy()[0], np.asarray(want)[0]
    hit = b[..., 3] > 0
    np.testing.assert_array_equal(a[..., 3] > 0, hit)
    exact = _f64_texels(verts, faces, uvs, tex_u8, hit)
    np.testing.assert_array_equal(a[hit], exact[hit])
    same = (a == b).all(-1)
    assert same[hit].mean() > 0.985, same[hit].mean()


def test_tex_loop_zclip_off_flags_out_of_range():
    # mirror: z outside [0, 1] with z_clip=False raises the overflow flag
    rng = np.random.default_rng(14)
    verts, faces, uvs = mesh.quad_batch(6, seed=14)
    tex_u8 = rng.integers(0, 256, (32, 32, 4), np.uint8)
    zmap = np.eye(4, dtype=np.float32)
    zmap[2, 2] = 0.25
    zmap[2, 3] = 1.5            # z' = 0.25 z + 1.5 > 1 for every vertex
    v, f, u, tex = _t(verts, faces, uvs, tex_u8)
    _, ovf = tr.render_textured_u8_loop(
        v, f, u, tex, W, H, torch.from_numpy(zmap[None]), capacity=512,
        z_clip=False, **TILE)
    assert bool(ovf)
    _, ovf_clip = tr.render_textured_u8_loop(
        v, f, u, tex, W, H, torch.from_numpy(zmap[None]), capacity=512,
        **TILE)
    assert not bool(ovf_clip)


def test_tex_tiled_matches_detiled():
    # mirror, over every frame of the batch: tiled=True's (B, NT, P, 4)
    # layout detiles to the detiled frames, viewport crop included
    # (H = 48 does not divide tile_h = 32)
    rng = np.random.default_rng(16)
    verts, faces, uvs = mesh.quad_batch(10, seed=16)
    tex_u8 = rng.integers(0, 256, (64, 64, 4), np.uint8)
    zmap = np.eye(4, dtype=np.float32)
    zmap[2, 2] = 0.25
    zmap[2, 3] = 0.5
    mvps = torch.from_numpy(np.stack([
        zmap @ mesh.rotation_y(0.5) @ mesh.rotation_x(0.2),
        zmap @ mesh.rotation_y(-0.7)]).astype(np.float32))
    args = (*_t(verts, faces, uvs, tex_u8), W, H, mvps)
    kw = dict(tile_w=32, tile_h=32, capacity=512, span_x=8, span_y=8)
    base, ovf = tr.render_textured_u8_loop(*args, **kw)
    tiles, ovf_t = tr.render_textured_u8_loop(*args, tiled=True, **kw)
    assert not bool(ovf) and not bool(ovf_t)
    assert tiles.shape == (mvps.shape[0], 2 * 2, 32 * 32, 4)
    assert not np.array_equal(base[0].numpy(), base[1].numpy())
    for b in range(mvps.shape[0]):
        np.testing.assert_array_equal(
            tr.detile_u8_host(tiles[b], W, H, 32, 32), base[b].numpy())


def test_tex_zclip_false_boundary_golden():
    """Mirror of the golden u8 contract for z_clip=False at the zz ~ 0/1
    depth boundaries: no per-pixel z rejection, the quantised depth
    clamped; the port must equal the scanline oracle on every pixel."""
    from libnativecpurenderer_tpu.golden.raster_reference import project
    rng = np.random.default_rng(31)
    tex_u8 = rng.integers(0, 256, (4, 4, 4)).astype(np.uint8)
    verts, faces, uvs = [], [], []

    def quad(x0, y0, x1, y1, z):
        b = len(verts)
        zs = z if isinstance(z, tuple) else (z, z, z, z)
        verts.extend([[x0, y0, zs[0]], [x1, y0, zs[1]],
                      [x1, y1, zs[2]], [x0, y1, zs[3]]])
        uvs.extend([[0.031, 0.067], [0.911, 0.067], [0.911, 0.941],
                    [0.031, 0.941]])
        faces.extend([[b, b + 1, b + 2], [b, b + 2, b + 3]])

    quad(-0.9, -0.8, -0.4, 0.7, -1.0)            # sz = 0 exactly
    quad(-0.3, -0.8, 0.25, 0.7, 1.0)             # sz = 1 exactly
    quad(0.35, -0.8, 0.9, 0.7, (-1.0, 1.0, 1.0, -1.0))  # sweeps 0..1
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    uvs = np.asarray(uvs, np.float32)

    got, ovf = tr.render_textured_u8_loop(
        *_t(verts, faces, uvs, tex_u8), W, H, torch.eye(4)[None],
        capacity=512, z_clip=False, **TILE)
    assert not bool(ovf)

    sx, sy, sz, _ = project(np.asarray(verts, np.float64), np.eye(4), W, H)
    th_t, tw_t = tex_u8.shape[0], tex_u8.shape[1]
    keybuf = np.full((H, W), tr.SKY_KEY, np.int64)
    want = np.zeros((H, W, 4), np.uint8)
    for fi, (i0, i1, i2) in enumerate(faces):
        x0, y0, x1, y1, x2, y2 = (sx[i0], sy[i0], sx[i1], sy[i1],
                                  sx[i2], sy[i2])
        area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        sign = np.sign(area2)
        for py in range(H):
            for px in range(W):
                e0 = (y1 - y2) * px + (x2 - x1) * py + (x1 * y2 - x2 * y1)
                e1 = (y2 - y0) * px + (x0 - x2) * py + (x2 * y0 - x0 * y2)
                e2 = (y0 - y1) * px + (x1 - x0) * py + (x0 * y1 - x1 * y0)
                if e0 * sign < 0 or e1 * sign < 0 or e2 * sign < 0:
                    continue
                w0, w1, w2 = e0 / area2, e1 / area2, e2 / area2
                z = w0 * sz[i0] + w1 * sz[i1] + w2 * sz[i2]
                zq = int(np.clip(z * tr.Z_LEVELS, 0, tr.Z_LEVELS))
                key = (zq << tr.IDX_BITS) | fi
                if key < keybuf[py, px]:
                    keybuf[py, px] = key
                    wsum = w0 + w1 + w2
                    uu = (w0 * uvs[i0, 0] + w1 * uvs[i1, 0]
                          + w2 * uvs[i2, 0]) / wsum
                    vv = (w0 * uvs[i0, 1] + w1 * uvs[i1, 1]
                          + w2 * uvs[i2, 1]) / wsum
                    ui = int(np.clip(np.trunc(uu * tw_t), 0, tw_t - 1))
                    vi = int(np.clip(np.trunc(vv * th_t), 0, th_t - 1))
                    want[py, px] = tex_u8[vi, ui]
    assert (keybuf != tr.SKY_KEY).mean() > 0.3
    np.testing.assert_array_equal(got[0].numpy(), want)


class _TiledSink:
    def __init__(self):
        self.tiled, self.frames = [], []

    def put_frame_tiled_u8(self, tiles, w, h, tw, th):
        self.tiled.append(np.asarray(tiles).copy())
        self.frames.append(tr.detile_u8_host(tiles, w, h, tw, th))


class _PlainSink:
    def __init__(self):
        self.frames = []

    def put_frame_u8(self, u8):
        self.frames.append(np.asarray(u8).copy())


def test_mesh_video_pipeline_textured():
    # mirror of test_pipeline.test_mesh_video_pipeline_textured: the port's
    # pipeline on the CPU, tiled and plain sinks, a batch remainder, against
    # JAX's render_textured_pallas_loop (the contract above: same texel on
    # >= 99.5 % of the pixels)
    W2, H2 = 70, 50
    verts, faces, uvs = mesh.quad_batch(8, seed=5)
    rng = np.random.default_rng(5)
    tex_u8 = rng.integers(0, 256, (32, 32, 4)).astype(np.uint8)
    mvps = np.stack([np.eye(4, dtype=np.float32)] * 3)
    mvps[1][2, 2] = 0.5
    mvps[2] = (mesh.rotation_y(0.4) @ mesh.rotation_x(0.2)).astype(
        np.float32)
    kw = dict(capacity=512, **TILE)
    sinks = (_TiledSink(), _PlainSink())
    for sink in sinks:
        pipe = port.MeshVideoPipeline(sink, W2, H2, verts, faces, uvs=uvs,
                                      tex_u8=tex_u8, batch=2, device="cpu",
                                      **kw)
        for m in mvps:
            pipe.submit(m)
        pipe.finish()
    assert len(sinks[0].tiled) == len(sinks[1].frames) == 3
    base, ovf = jr.render_textured_pallas_loop(
        jnp.asarray(verts, jnp.float32), jnp.asarray(faces, jnp.int32),
        jnp.asarray(uvs, jnp.float32), jnp.asarray(tex_u8), W2, H2,
        mvps=jnp.asarray(mvps), interpret=True, mega=0, **kw)
    assert not bool(ovf)
    for i in range(3):
        np.testing.assert_array_equal(sinks[0].frames[i], sinks[1].frames[i])
        same = (sinks[1].frames[i] == np.asarray(base[i])).all(-1)
        assert same.mean() >= 0.995, same.mean()


# ------------------------------------------------------------------ #
# the port's argument contracts
# ------------------------------------------------------------------ #

def _small():
    verts, faces, uvs = mesh.quad_batch(2, seed=1)
    return _t(verts, faces, uvs, _tex((8, 8), 1))


@pytest.mark.parametrize("knob,value", [
    ("interpret", True), ("tex_nw", 14), ("fb_tile_cap", 1024), ("mxu", 1),
    ("tex_split", True), ("mega", 8), ("tex_dyn", True), ("out8", True),
    ("ktail", 8), ("tex_when", 4), ("tex_skip", True), ("fb_subrow", True)])
def test_textured_tpu_knobs_raise_type_error(knob, value):
    v, f, u, tex = _small()
    mvps = torch.eye(4)[None]
    batch = lambda: tr.render_textured_u8_batch(v, f, u, tex, W, H,  # noqa
                                                mvps, **{knob: value})
    if knob == "mxu":
        # the batch entry walks K3's matrix-unit walk with mxu, as JAX's
        # render_textured_pallas_batch does; the others refuse it
        frames, ovf = batch()
        assert frames.shape == (1, H, W, 4) and not bool(ovf)
        batch = None
    for call in (lambda: tr.render_textured_u8(v, f, u, tex, W, H,
                                               **{knob: value}),
                 lambda: tr.render_textured_u8_loop(v, f, u, tex, W, H, mvps,
                                                    **{knob: value}),
                 *([batch] if batch else []),
                 lambda: tr.render_textured(v, f, u, tex.float(), W, H,
                                            **{knob: value}),
                 lambda: port.MeshVideoPipeline(
                     object(), W, H, v.numpy(), f.numpy(), uvs=u.numpy(),
                     tex_u8=tex.numpy(), device="cpu", **{knob: value})):
        with pytest.raises(TypeError):
            call()


@pytest.mark.parametrize("tile_w,tile_h", [(8, 8), (32, 4), (20, 16),
                                           (16, 16), (24, 16)])
def test_textured_tiles_follow_the_jax_lane_rule(tile_w, tile_h):
    # the JAX launcher takes P % 128 == 0 and P >= 256 only; the port
    # accepts exactly the same tile shapes
    v, f, u, tex = _small()
    P = tile_w * tile_h
    if P % 128 == 0 and P >= 256:
        frame, _ = tr.render_textured_u8(v, f, u, tex, W, H, tile_w=tile_w,
                                         tile_h=tile_h, capacity=64,
                                         span_x=8, span_y=8)
        assert frame.shape == (H, W, 4)
        return
    with pytest.raises(ValueError, match="P % 128"):
        jp.raster_tiles_tex(jnp.zeros(256, jnp.int32), jnp.zeros((2, 32)),
                            jnp.zeros(6, jnp.int32),
                            jnp.zeros((8, 128), jnp.int32), 1, tile_h,
                            tile_w, 128, True, 16, 0, (8, 8))
    with pytest.raises(ValueError, match="P % 128"):
        tr.render_textured_u8(v, f, u, tex, W, H, tile_w=tile_w,
                              tile_h=tile_h)


def test_textured_pipeline_defaults_to_the_card(monkeypatch):
    # MeshVideoPipeline runs on the card unless asked for the CPU: with
    # no card, leaving out device= raises as_device's error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces, uvs = mesh.quad_batch(2, seed=1)
    with pytest.raises(RuntimeError, match="is_available"):
        port.MeshVideoPipeline(object(), W, H, verts, faces, uvs=uvs,
                               tex_u8=_tex((8, 8), 1))
    with pytest.raises(RuntimeError, match="is_available"):
        port.MeshVideoPipeline(object(), W, H, verts, faces,
                               colors=np.ones((len(verts), 4)))


def test_textured_wrappers_check_inputs_and_count_only_launches():
    v, f, u, tex = _small()
    prep = tr.prepare_textured_frame(v, f, u[f], W, H, torch.eye(4),
                                     capacity=64, perspective_correct=True,
                                     z_clip=True, **TILE)
    args = (prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"])
    packed_tex = tr.pack_texture_u8(tex)
    bgp = tt.pack_bg(torch.zeros(4))
    counters = (tt.raster_tiles_tex_u8, tt.raster_tiles_tex_idx,
                tt.raster_tiles_keys_f32)
    before = [c.launches for c in counters]
    tt.raster_tiles_tex_u8(*args, packed_tex, (8, 8), bgp, W, 32, 8,
                           z_clip=True)
    tt.raster_tiles_tex_idx(*args, (8, 8), W, 32, 8, z_clip=True)
    tt.raster_tiles_keys_f32(*args, W, 32, 8, z_clip=True)
    # the CPU runs are the plain versions, not kernel launches
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="tex_packed"):
        tt.raster_tiles_tex_u8(*args, packed_tex[:-1], (8, 8), bgp, W, 32, 8,
                               z_clip=True)
    with pytest.raises(TypeError):
        tt.raster_tiles_tex_u8(*args, packed_tex.long(), (8, 8), bgp, W, 32,
                               8, z_clip=True)
    with pytest.raises(ValueError, match="dims"):
        tt.raster_tiles_tex_idx(*args, (0, 8), W, 32, 8, z_clip=True)
    meta = [a.to("meta") for a in args]
    for name, call in (
            ("K3", lambda: tt.raster_tiles_tex_u8(
                *meta, packed_tex.to("meta"), (8, 8), bgp.to("meta"), W, 32,
                8, z_clip=True)),
            ("K2b", lambda: tt.raster_tiles_tex_idx(*meta, (8, 8), W, 32, 8,
                                                    z_clip=True)),
            ("K2a", lambda: tt.raster_tiles_keys_f32(*meta, W, 32, 8,
                                                     z_clip=True))):
        with pytest.raises(ValueError, match=f"no {name} kernel"):
            call()
