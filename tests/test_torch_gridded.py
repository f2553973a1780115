"""Kernels K5 (the gridded kernel over materialised bins) and K6 (the
kernel over rows gathered in pair order) of the PyTorch port, and the
binning that feeds K5, against the JAX package at 64x32 on the JAX
suite's icosphere scene (``test_pallas_raster._scene``).

On the CPU each wrapper runs its plain torch version (chip_smoke.py holds
the CUDA kernels to them on the card).  The JAX kernels run in interpret
mode, fed the JAX package's own prep, which ``interop.
kernel_inputs_to_torch`` carries into the port.  XLA:CPU may fuse a
multiply and an add in the interpreted kernels (ROADMAP "Parity
contracts"), so port and JAX are held to:
  * ``bin_triangles``: bins, counts and the overflow flag exact;
  * K5: sky mask exact, the key's z part within 1 level, its slot bits
    exact where the z part agrees, rgba within 2e-5 (the tolerance of
    test_pallas_raster.test_pallas_matches_naive);
  * K6: sky mask exact, RGB within 1 u8 level on at most 0.5 % of the
    pixels (test_torch_tile_raster's contract for K1).
Within the port the sources agree bit for bit: K6 with K1 on the same
frames, K5 with K2a where the bins are the flat runs, and K1, K2a and K3
with a walk written out as it stood before the row source became a
parameter.
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
TW, TH = 32, 8
NT = (W // TW) * (H // TH)
BG = np.array([0.12, 0.34, 0.56, 0.0], np.float32)


def _scene():
    """test_pallas_raster._scene as float32 numpy arrays."""
    verts, faces = mesh.icosphere(2)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    mvp = (mesh.perspective(1.0, W / H, 0.1, 10.0)
           @ mesh.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
           @ mesh.rotation_x(0.4))
    return (verts.astype(np.float32), faces.astype(np.int32),
            colors.astype(np.float32), mvp.astype(np.float32))


def _mvps():
    m = _scene()[3]
    return np.stack([m, m @ mesh.rotation_y(0.4).astype(np.float32),
                     m @ mesh.rotation_x(0.7).astype(np.float32)])


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_bins_prep(v, f, c, m, capacity, span):
    """render_gouraud_pallas's default prep: bins with NO_TRI sent to the
    pad row F, counts, the row table, the flag."""
    tri = jr.setup_triangles(v, f, m, W, H)
    A, B, C, ia, sg, vl = jr.edge_coeffs(tri["sxy"], tri["z"], tri["valid"])
    bins, counts, ovf = jr.bin_triangles(tri["sxy"], vl, W, H, TW, TH,
                                         capacity, span, span)
    table = jp.build_table(A, B, C, tri["z"] * ia[:, None], ia, sg, vl, c[f])
    return jnp.where(bins == jr.NO_TRI, f.shape[0], bins), counts, table, ovf


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_flat_prep(v, f, c, m, rows_cap):
    """render_gouraud_pallas_batch(dynrows=)'s per-frame prep: rows,
    starts, counts, and the flat kernel's sorted pairs and table."""
    tri = jr.setup_triangles(v, f, m, W, H)
    A, B, C, ia, sg, vl = jr.edge_coeffs(tri["sxy"], tri["z"], tri["valid"])
    sp, st, ct, ovf = jr.bin_triangles_flat(tri["sxy"], vl, W, H, TW, TH, 96,
                                            8, 8, edges=(A, B, C, sg))
    table = jp.build_table(A, B, C, tri["z"] * ia[:, None], ia, sg, vl, c[f])
    rows = jnp.take(table, sp[:rows_cap] & jr.IDX_MASK, axis=0)
    return rows, st, ct, sp, table, ovf


@functools.lru_cache(maxsize=None)
def _k5_case():
    """JAX's bins prep of the scene and its interpreted K5 outputs."""
    v, f, c, m = (jnp.asarray(a) for a in _scene())
    safe, counts, table, ovf = _jax_bins_prep(v, f, c, m, 96, 8)
    assert not bool(ovf)
    tids = jnp.arange(NT, dtype=jnp.int32)
    scalars = jnp.concatenate([counts.astype(jnp.int32), tids % 2 * TW,
                               tids // 2 * TH])
    keys, rgba = jp.raster_tiles(safe, table, scalars, NT, TH, TW, True)
    return ((np.asarray(safe), np.asarray(counts), np.asarray(table)),
            np.asarray(keys).reshape(NT, -1), np.asarray(rgba))


@functools.lru_cache(maxsize=None)
def _k6_case(g):
    """JAX's dynrows prep of the 3 frames (rows_cap 2048) and its
    interpreted K6 frames (B, H, W, 4), g frames a program."""
    v, f, c, _ = (jnp.asarray(a) for a in _scene())
    preps = [_jax_flat_prep(v, f, c, jnp.asarray(m), 2048) for m in _mvps()]
    assert not any(bool(p[-1]) for p in preps)
    rows, st, ct, sp, tb = (jnp.stack([p[i] for p in preps])
                            for i in range(5))
    frames = jp.render_binned_dynrows_batch_u8(rows, st, ct, jnp.asarray(BG),
                                               W, H, TW, TH, g, 8, True)
    return (tuple(np.asarray(a) for a in (rows, st, ct, sp, tb)),
            np.asarray(frames))


def assert_keys_rgba_close(keys, rgba, want_keys, want_rgba):
    """K5 port vs JAX: see the module docstring."""
    sky = want_keys == tr.SKY_KEY
    np.testing.assert_array_equal(keys == tr.SKY_KEY, sky)
    assert 0.2 < sky.mean() < 0.8
    zp, zj = keys >> tr.IDX_BITS, want_keys >> tr.IDX_BITS
    assert np.abs(zp - zj).max() <= 1
    same = zp == zj
    assert same.mean() >= 0.995
    np.testing.assert_array_equal((keys & tr.IDX_MASK)[same],
                                  (want_keys & tr.IDX_MASK)[same])
    np.testing.assert_allclose(rgba, want_rgba, atol=2e-5)


def test_k5_matches_jax_kernel():
    (safe, counts, table), want_k, want_r = _k5_case()
    ins = interop.kernel_inputs_to_torch("cpu", safe, counts, table)
    assert [t.dtype for t in ins] == [torch.int32, torch.int32,
                                      torch.float32]
    keys, rgba = tt.raster_tiles_bins_f32(*ins, W, TW, TH)
    assert keys.shape == (NT, TW * TH) and rgba.shape == (NT, 4, TW * TH)
    assert not rgba.numpy()[np.broadcast_to(
        (keys == tr.SKY_KEY).numpy()[:, None], rgba.shape)].any()
    assert_keys_rgba_close(keys.numpy(), rgba.numpy(), want_k, want_r)
    # slot ids, not triangle ids: every hit's slot lies inside its run
    slot = (keys & tr.IDX_MASK).numpy()
    hit = keys.numpy() != tr.SKY_KEY
    assert (slot < counts[:, None])[hit].all()


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_render_binned_pallas(v, f, c, m, return_ids):
    tri = jr.setup_triangles(v, f, m, W, H)
    A, B, C, ia, sg, vl = jr.edge_coeffs(tri["sxy"], tri["z"], tri["valid"])
    bins, counts, _ = jr.bin_triangles(tri["sxy"], vl, W, H, TW, TH, 96, 8,
                                       8)
    edges = (A, B, C, tri["z"] * ia[:, None], ia, sg, vl)
    keys, rgba = jp.render_binned_pallas(bins, counts, *edges, c[f],
                                         jnp.asarray(BG), W, H, TW, TH,
                                         True, return_ids)
    return (bins, counts) + edges + (c[f], keys, rgba)


@pytest.mark.parametrize("return_ids", [False, True])
def test_render_binned_pallas_matches_jax(return_ids):
    # the K5 entry on JAX's bins and edges: with return_ids the key's id
    # bits are global triangle ids (bins[t, slot]), else bin slots
    *ins, want_k, want_r = _jax_render_binned_pallas(
        *(jnp.asarray(a) for a in _scene()), return_ids)
    ins = [torch.from_numpy(np.array(a)) for a in ins]
    keys, rgba = tt.render_binned_pallas(*ins, torch.from_numpy(BG), W, H,
                                         TW, TH, return_ids=return_ids)
    assert keys.shape == (H, W) and rgba.shape == (H, W, 4)
    assert_keys_rgba_close(keys.numpy(), rgba.numpy(), np.asarray(want_k),
                           np.asarray(want_r))
    sky = keys == tr.SKY_KEY
    np.testing.assert_array_equal(rgba[sky].numpy(),
                                  np.broadcast_to(BG, rgba[sky].shape))
    ids = (keys & tr.IDX_MASK)[~sky]
    if return_ids:
        assert int(ids.max()) >= 96     # triangle ids, past any slot
    else:
        assert int(ids.max()) < 96


def test_k5_batch_matches_jax_batch():
    # two frames through one launch, each tile reading its frame's table;
    # the second frame is the first with its table's rows reversed
    # (bins renumbered), so a wrong table pick shows
    (safe, counts, table), _, _ = _k5_case()
    F = table.shape[0] - 1
    perm = np.concatenate([np.arange(F)[::-1], [F]])
    inv = np.argsort(perm)
    tables = np.stack([table, table[perm]])
    bins = np.stack([safe, inv[safe].astype(np.int32)])
    cts = np.stack([counts, counts])
    bg = jnp.asarray(BG)
    wk, wr = jp.render_binned_pallas_batch(
        jnp.asarray(bins), jnp.asarray(cts), jnp.asarray(tables), bg, W, H,
        TW, TH, True)
    keys, rgba = tt.render_binned_pallas_batch(
        *interop.kernel_inputs_to_torch("cpu", bins, cts, tables),
        torch.from_numpy(BG), W, H, TW, TH)
    assert keys.shape == (2, H, W) and rgba.shape == (2, H, W, 4)
    assert_keys_rgba_close(keys.numpy(), rgba.numpy(), np.asarray(wk),
                           np.asarray(wr))
    np.testing.assert_array_equal(keys[0].numpy(), keys[1].numpy())
    np.testing.assert_array_equal(rgba[0].numpy(), rgba[1].numpy())


def test_k5_overflowed_tile_reads_in_bounds():
    # 60 coincident triangles in one tile, capacity 16: the tile's count
    # (60) exceeds its bins row, the flag is raised, and K5 walks the 16
    # slots it has (the same as a count of 16), reading nothing past them
    verts = np.tile(np.array([[-0.1, -0.1, 0.5], [0.1, -0.1, 0.5],
                              [0.0, 0.1, 0.5]], np.float32), (60, 1))
    colors = np.random.default_rng(2).uniform(0, 1, (180, 4)).astype(
        np.float32)
    faces = np.arange(180).reshape(60, 3)
    v, f, c = interop.mesh_to_torch(verts, faces, colors, "cpu")
    tri = tr.setup_triangles(v, f, torch.eye(4), W, H)
    A, B, C, ia, sg, vl = tr.edge_coeffs(tri["sxy"], tri["z"], tri["valid"])
    bins, counts, ovf = tr.bin_triangles(tri["sxy"], vl, W, H, 16, 8, 16)
    assert bool(ovf) and int(counts.max()) == 60 and bins.shape[1] == 16
    table = tt.build_table(A, B, C, tri["z"] * ia[:, None], ia, sg, vl,
                           c[f])
    safe = torch.where(bins == tr.NO_TRI, 60, bins)
    keys, rgba = tt.raster_tiles_bins_f32(safe, counts, table, W, 16, 8)
    k16, r16 = tt.raster_tiles_bins_f32(safe, counts.clamp(max=16), table,
                                        W, 16, 8)
    assert torch.equal(keys, k16) and torch.equal(rgba, r16)
    hit = keys != tr.SKY_KEY
    assert hit.any() and ((keys & tr.IDX_MASK)[hit] < 16).all()
    # every triangle is the same and z ties: the lowest slot wins
    assert ((keys & tr.IDX_MASK)[hit] == 0).all()


@pytest.mark.parametrize("g", [1, 3])
def test_k6_matches_jax_kernel(g):
    from test_torch_tile_raster import assert_u8_close
    (rows, st, ct, _, _), want = _k6_case(g)
    ins = interop.kernel_inputs_to_torch("cpu", rows, st, ct)
    got = tt.render_binned_dynrows_batch_u8(*ins, torch.from_numpy(BG), W,
                                            H, TW, TH, g=g)
    assert got.shape == (3, H, W, 4) and got.dtype == torch.uint8
    assert_u8_close(got.numpy(), want)
    assert set(np.unique(got.numpy()[..., 3])) == {0, 255}


def test_k6_equals_k1_bit_for_bit():
    # the same frames, rows gathered in pair order vs read through the
    # pair array: K6's plain version == K1's (opaque, z_clip off)
    (rows, st, ct, sp, tb), _ = _k6_case(1)
    rows, st, ct, sp, tb = interop.kernel_inputs_to_torch("cpu", rows, st,
                                                          ct, sp, tb)
    bgp = tt.pack_bg(torch.from_numpy(BG))
    k6 = tt.raster_tiles_rows_u8(rows, st, ct, bgp, W, TW, TH)
    k1 = tt.raster_tiles_flat_u8(sp, st, ct, tb, bgp, W, TW, TH,
                                 opaque=True, z_clip=False)
    assert k6.shape == (3, NT, TW * TH)
    assert torch.equal(k6, k1)
    # one frame at a time through K1 gives the same tiles too
    for b in range(3):
        assert torch.equal(k1[b], tt.raster_tiles_flat_u8(
            sp[b], st[b], ct[b], tb[b], bgp, W, TW, TH, opaque=True,
            z_clip=False))


def test_k6_reads_clamped_below_rows_cap():
    # runs ending past the gathered rows (a flagged frame) read the last
    # row instead of past the array
    (rows, st, ct, _, _), _ = _k6_case(1)
    rows, st, ct = interop.kernel_inputs_to_torch("cpu", rows, st, ct)
    cut = int((st[:, -1] + ct[:, -1]).min()) - 5
    bgp = tt.pack_bg(torch.from_numpy(BG))
    got = tt.raster_tiles_rows_u8(rows[:, :cut].contiguous(), st, ct, bgp,
                                  W, TW, TH)
    full = tt.raster_tiles_rows_u8(rows, st, ct, bgp, W, TW, TH)
    assert got.shape == full.shape
    # tiles whose runs end inside the cut are untouched
    inside = (st + ct <= cut)
    assert torch.equal(got[inside], full[inside])


def test_k5_with_flat_runs_as_bins_equals_k2a():
    # bins holding exactly the flat runs: K5 and K2a walk the same rows
    # in the same order, so keys and attribute bits are equal
    v, f, c, m = interop.mesh_to_torch(*_scene()[:3], "cpu") + (
        torch.from_numpy(_scene()[3]),)
    prep = tr.prepare_frame(v, f, c, W, H, m, tile_w=TW, tile_h=TH,
                            capacity=96)
    sp, st, ct, tb = (prep[k] for k in ("sorted_pad", "starts", "counts",
                                        "table"))
    K = int(ct.max())
    win = (st[:, None] + torch.arange(K, dtype=torch.int32)).clamp(
        max=sp.shape[0] - 1)
    bins = torch.where(torch.arange(K) < ct[:, None],
                       sp[win.long()] & tr.IDX_MASK, f.shape[0])
    k5 = tt.raster_tiles_bins_f32(bins.to(torch.int32), ct, tb, W, TW, TH)
    k2a = tt.raster_tiles_keys_f32(sp, st, ct, tb, W, TW, TH, z_clip=True)
    assert torch.equal(k5[0], k2a[0])
    assert torch.equal(k5[1].view(torch.int32), k2a[1].view(torch.int32))


def _walk_before(sorted_pad, starts, counts, table, width, tile_w, tile_h,
                 z_clip):
    """The plain walk over the pair array as it stood before the row
    source became a parameter: every tile through every chunk."""
    nt, P = starts.shape[0], tile_w * tile_h
    ntx = (width + tile_w - 1) // tile_w
    i32 = torch.int32
    t = torch.arange(nt, dtype=i32)
    p = torch.arange(P, dtype=i32)
    X = ((t % ntx * tile_w)[:, None] + p % tile_w).to(torch.float32)
    Y = ((t // ntx * tile_h)[:, None] + p // tile_w).to(torch.float32)

    def rows_at(slots):
        idx = (starts.reshape((nt,) + (1,) * (slots.dim() - 1))
               + slots).clamp(max=sorted_pad.shape[0] - 1).long()
        tri = (sorted_pad[idx] & tr.IDX_MASK).clamp(max=table.shape[0] - 1)
        return table[tri.long()]

    best = torch.full((nt, P), tr.SKY_KEY, dtype=i32)
    for base in range(0, int(counts.max()), tt.REF_CHUNK):
        j = base + torch.arange(tt.REF_CHUNK, dtype=i32)
        r = rows_at(j[None, :])[:, :, None, :]
        e0, e1, e2 = tt._edges(r, X[:, None, :], Y[:, None, :])
        zz = e0 * r[..., 9] + e1 * r[..., 10] + e2 * r[..., 11]
        cov = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        if z_clip:
            cov = cov & (zz >= 0.0) & (zz <= 1.0)
        cov = cov & (j[None, :] < counts[:, None])[..., None]
        keys = ((zz * tr.Z_LEVELS).to(i32) << tr.IDX_BITS) | j[None, :, None]
        best = torch.minimum(best, torch.where(cov, keys, tr.SKY_KEY).amin(1))
    slot = torch.where(best != tr.SKY_KEY, best & tr.IDX_MASK, 0)
    r = rows_at(slot)
    e = tt._edges(r, X, Y)
    return best, lambda d: tt._channel(r, e, d)


@pytest.mark.parametrize("opaque,z_clip", [(True, False), (False, True)])
def test_row_source_leaves_k1_k2a_bit_identical(opaque, z_clip):
    v, f, c, m = interop.mesh_to_torch(*_scene()[:3], "cpu") + (
        torch.from_numpy(_scene()[3]),)
    prep = tr.prepare_frame(v, f, c, W, H, m, tile_w=TW, tile_h=TH,
                            capacity=96, z_clip=z_clip)
    walk = (prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"])
    best, attr = _walk_before(*walk, W, TW, TH, z_clip)
    bgp = tt.pack_bg(torch.from_numpy(BG))
    assert torch.equal(
        tt.raster_tiles_flat_u8(*walk, bgp, W, TW, TH, opaque=opaque,
                                z_clip=z_clip),
        tt._u8_epilogue(best, attr, bgp, opaque))
    keys, rgba = tt.raster_tiles_keys_f32(*walk, W, TW, TH, z_clip=z_clip)
    want_k, want_r = tt._keys_f32_epilogue(best, attr)
    assert torch.equal(keys, want_k)
    assert torch.equal(rgba.view(torch.int32), want_r.view(torch.int32))


def test_row_source_leaves_k3_bit_identical():
    # test_torch_textured's quads under its side camera, 32x8 tiles
    from test_torch_textured import _camera, _quads, _tex
    verts, faces, uvs = _quads()
    v, f, u, tex = interop.textured_mesh_to_torch(
        verts, faces, uvs, _tex((24, 40), 4), "cpu")
    prep = tr.prepare_textured_frame(
        v, f, u[f], 64, 48, torch.from_numpy(_camera()), tile_w=32, tile_h=8,
        capacity=64, span_x=8, span_y=8, perspective_correct=True,
        z_clip=True)
    walk = (prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"])
    best, attr = _walk_before(*walk, 64, 32, 8, True)
    packed = tr.pack_texture_u8(tex)
    bgp = tt.pack_bg(torch.zeros(4))
    got = tt.raster_tiles_tex_u8(*walk, packed, (24, 40), bgp, 64, 32, 8,
                                 z_clip=True)
    want = torch.where(best != tr.SKY_KEY,
                       packed[tt._texel_index(attr, (24, 40)).long()], bgp)
    assert torch.equal(got, want)
    assert (best != tr.SKY_KEY).float().mean() > 0.2


def _bin_inputs():
    """(sxy, valid) of the scene and of 3 random fuzz scenes, from JAX's
    setup, as numpy arrays."""
    out = []
    v, f, _, m = _scene()
    tri = jr.setup_triangles(jnp.asarray(v), jnp.asarray(f), jnp.asarray(m),
                             W, H)
    out.append((np.asarray(tri["sxy"]), np.asarray(tri["valid"])))
    rng = np.random.default_rng(11)
    for _ in range(3):
        verts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
        faces = rng.integers(0, 50, (30, 3)).astype(np.int32)
        tri = jr.setup_triangles(jnp.asarray(verts), jnp.asarray(faces),
                                 jnp.eye(4, dtype=jnp.float32), W, H)
        out.append((np.asarray(tri["sxy"]), np.asarray(tri["valid"])))
    return out


@pytest.mark.parametrize("cfg", [(32, 8, 96, 8, 8), (16, 8, 16, 3, 5),
                                 (8, 8, 24, 4, 4)])
def test_bin_triangles_matches_jax(cfg):
    tw, th, cap, sx, sy = cfg
    flags = []
    for sxy, valid in _bin_inputs():
        want = jr.bin_triangles(jnp.asarray(sxy), jnp.asarray(valid), W, H,
                                tw, th, cap, sx, sy)
        got = tr.bin_triangles(torch.from_numpy(sxy),
                               torch.from_numpy(valid), W, H, tw, th, cap,
                               sx, sy)
        assert got[0].dtype == got[1].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert bool(got[2]) == bool(want[2])
        flags.append(bool(got[2]))
    if cfg[2] == 16:
        assert any(flags)          # some scene overflows the small bins


def test_bin_triangles_tile_limit():
    sxy = torch.zeros((1, 3, 2))
    with pytest.raises(ValueError, match="too many"):
        tr.bin_triangles(sxy, torch.ones(1, dtype=torch.bool), 8192, 8, 1, 1,
                         4)


def test_new_wrappers_check_inputs_and_count_only_kernel_launches():
    (safe, counts, table), _, _ = _k5_case()
    b, c, t = interop.kernel_inputs_to_torch("cpu", safe, counts, table)
    before = tt.raster_tiles_bins_f32.launches
    tt.raster_tiles_bins_f32(b, c, t, W, TW, TH)
    assert tt.raster_tiles_bins_f32.launches == before
    with pytest.raises(TypeError):
        tt.raster_tiles_bins_f32(b.long(), c, t, W, TW, TH)
    with pytest.raises(ValueError):
        tt.raster_tiles_bins_f32(b, c[:-1], t, W, TW, TH)
    with pytest.raises(ValueError, match="plus K > 0 slots"):
        tt.raster_tiles_bins_f32(b[None], c, t[None], W, TW, TH)
    with pytest.raises(ValueError, match="matching counts"):
        tt.raster_tiles_bins_f32(b[None], c[None], t, W, TW, TH)
    with pytest.raises(ValueError, match="no K5 kernel"):
        tt.raster_tiles_bins_f32(*(x.to("meta") for x in (b, c, t)), W, TW,
                                 TH)
    (rows, st, ct, _, _), _ = _k6_case(1)
    r, s, n = interop.kernel_inputs_to_torch("cpu", rows, st, ct)
    bgp = tt.pack_bg(torch.from_numpy(BG))
    before = tt.raster_tiles_rows_u8.launches
    tt.raster_tiles_rows_u8(r, s, n, bgp, W, TW, TH)
    assert tt.raster_tiles_rows_u8.launches == before
    with pytest.raises(ValueError, match="batch"):
        tt.raster_tiles_rows_u8(r[0], s[0], n[0], bgp, W, TW, TH)
    with pytest.raises(ValueError):
        tt.raster_tiles_rows_u8(r[:, :, :16].contiguous(), s, n, bgp, W, TW,
                                TH)
    with pytest.raises(ValueError, match="no K6 kernel"):
        tt.raster_tiles_rows_u8(*(x.to("meta") for x in (r, s, n, bgp)), W,
                                TW, TH)
