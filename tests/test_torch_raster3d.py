"""PyTorch port's mesh prep (libnativecpurenderer_tpu_torch.ops.raster3d)
against the JAX package: projection/snap, edge coefficients, row table
and gatherless binning, on the same float32 inputs made with numpy.

Tolerances: sxy, valid, edge coefficients, sorted pairs, starts, counts
and the overflow flag are exact; z (and the z columns of the row table,
which carry z * inv_area) within 2 ulp — XLA:CPU may fuse
ndc * 0.5 + 0.5 into one multiply-add, the port rounds each op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu.models import mesh
from libnativecpurenderer_tpu.ops import pallas_raster as jp
from libnativecpurenderer_tpu.ops import raster3d as jr
from libnativecpurenderer_tpu_torch.ops import raster3d as tr
from libnativecpurenderer_tpu_torch.ops import tile_raster as tt

torch.set_num_threads(1)

W, H = 64, 32

# the JAX binning run as one compiled program (eager it compiles op by op)
_jax_bin = jax.jit(jr.bin_triangles_flat, static_argnums=tuple(range(2, 9)))


def _cameras(n=4, seed=3):
    """The random orbit cameras of
    test_pallas_raster.test_flat_matches_naive_random_cameras, plus the
    fixed _scene camera first."""
    cams = [mesh.perspective(1.0, W / H, 0.1, 10.0)
            @ mesh.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0])
            @ mesh.rotation_x(0.4)]
    rng = np.random.default_rng(seed)
    for _ in range(n):
        eye = rng.uniform(-1, 1, 3)
        eye = eye / np.linalg.norm(eye) * rng.uniform(1.8, 4.0)
        cams.append(mesh.perspective(rng.uniform(0.7, 1.4), W / H, 0.1,
                                     10.0)
                    @ mesh.look_at(eye, [0, 0, 0], [0, 1, 0]))
    return [c.astype(np.float32) for c in cams]


def _sphere(subdiv=2):
    verts, faces = mesh.icosphere(subdiv)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    return (verts.astype(np.float32), faces.astype(np.int32),
            colors.astype(np.float32))


def _both_setups(verts, faces, mvp):
    tj = jr.setup_triangles(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(mvp), W, H)
    tq = tr.setup_triangles(torch.from_numpy(verts),
                            torch.from_numpy(faces.astype(np.int64)),
                            torch.from_numpy(mvp), W, H)
    return tj, tq


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cam", range(5))
def test_setup_and_edges_match_jax(cam):
    verts, faces, _ = _sphere()
    tj, tq = _both_setups(verts, faces, _cameras()[cam])
    np.testing.assert_array_equal(tq["sxy"].numpy(), np.asarray(tj["sxy"]))
    np.testing.assert_array_equal(tq["valid"].numpy(),
                                  np.asarray(tj["valid"]))
    np.testing.assert_array_max_ulp(tq["z"].numpy(), np.asarray(tj["z"]),
                                    maxulp=2)
    np.testing.assert_array_max_ulp(tq["inv_w"].numpy(),
                                    np.asarray(tj["inv_w"]), maxulp=2)
    ej = jr.edge_coeffs(tj["sxy"], tj["z"], tj["valid"])
    eq = tr.edge_coeffs(tq["sxy"], tq["z"], tq["valid"])
    for name, a, b in zip(("A", "B", "C", "inv_area", "sign", "valid"),
                          ej, eq):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    # the u8 entries' exact_c: C is the float64 difference of the exact
    # products rounded once to float32, bit for bit; eager JAX rounds each
    # product and the difference, within 1 ulp of the larger product of
    # it (measured: 1.0 on all five cameras), which is many ulps of a C
    # that cancels.  A, B, inv_area, sign and valid stay exact
    ex = tr.edge_coeffs(tq["sxy"], tq["z"], tq["valid"], exact_c=True)
    s = np.asarray(tj["sxy"]).astype(np.float64)
    x, y = s[..., 0], s[..., 1]
    p, q = x[:, [1, 2, 0]] * y[:, [2, 0, 1]], x[:, [2, 0, 1]] * y[:, [1, 2, 0]]
    np.testing.assert_array_equal(ex[2].numpy(), (p - q).astype(np.float32))
    ulp = np.spacing(np.maximum(np.abs(p), np.abs(q)).astype(np.float32))
    assert (np.abs(ex[2].numpy().astype(np.float64) - np.asarray(ej[2]))
            <= ulp).all()
    for i in (0, 1, 3, 4, 5):
        np.testing.assert_array_equal(ex[i].numpy(), eq[i].numpy())


def test_table_matches_jax():
    verts, faces, colors = _sphere()
    tj, tq = _both_setups(verts, faces, _cameras()[0])
    A, B, C, ia, sg, vl = jr.edge_coeffs(tj["sxy"], tj["z"], tj["valid"])
    want = np.asarray(jp.build_table(A, B, C, tj["z"] * ia[:, None], ia, sg,
                                     vl, jnp.asarray(colors)[faces]))
    Aq, Bq, Cq, iaq, sgq, vlq = tr.edge_coeffs(tq["sxy"], tq["z"],
                                               tq["valid"])
    got = tt.build_table(Aq, Bq, Cq, tq["z"] * iaq[:, None], iaq, sgq, vlq,
                         torch.from_numpy(colors)[faces]).numpy()
    assert got.shape == want.shape == (len(faces) + 1, tt.ROW_W)
    assert got.dtype == np.float32
    # NaN rows (invalid triangles, pad row F) in the same places
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    z_cols = slice(9, 12)
    other = np.r_[0:9, 12:tt.ROW_W]
    np.testing.assert_array_equal(got[:, other], want[:, other])
    ok = ~np.isnan(want[:, 0])
    np.testing.assert_array_max_ulp(got[ok, z_cols], want[ok, z_cols],
                                    maxulp=2)


def _jax_edges(verts, faces, mvp):
    tj = jr.setup_triangles(jnp.asarray(verts), jnp.asarray(faces),
                            jnp.asarray(mvp), W, H)
    A, B, C, ia, sg, vl = jr.edge_coeffs(tj["sxy"], tj["z"], tj["valid"])
    return tj["sxy"], vl, (A, B, C, sg)


def _bin_both(sxy, valid, edges, *args, **kw):
    want = _jax_bin(sxy, valid, W, H, *args, edges=edges, **kw)
    got = tr.bin_triangles_flat(_t(sxy), _t(valid), W, H, *args,
                                edges=tuple(_t(e) for e in edges), **kw)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("cfg", [(32, 8, 96, 4, 6), (16, 8, 96, 8, 8),
                                 (8, 8, 24, 3, 5)])
def test_bin_flat_matches_jax(cfg):
    # fed JAX's own sxy/valid/edges: sorted pair array (guard padding
    # included), starts, counts and the overflow flag are identical;
    # (8, 8, 24, 3, 5) overflows (runs longer than 24, wide AABBs)
    verts, faces, _ = _sphere()
    sxy, valid, edges = _jax_edges(verts, faces, _cameras()[1])
    want, got = _bin_both(sxy, valid, edges, *cfg)
    for name, a, b in zip(("sorted_pad", "starts", "counts", "overflow"),
                          want, got):
        assert a.dtype == b.dtype or name == "overflow", name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert bool(got[3]) == (cfg[2] == 24)


@pytest.mark.parametrize("tile_w", [8, 16])
def test_bin_flat_split_matches_jax(tile_w):
    # icosphere(4): F = 5120 >= 4096 with span_y > 4, so the top-k tall
    # split runs (the wide split is off, its JAX default).  Valid pairs,
    # starts, counts, flag and the padded length are exact; the sentinel
    # tail (tile NT) holds the unchosen split slots, whose triangle ids
    # follow top-k tie order — lax.top_k and torch.topk break ties
    # differently, and no kernel reads past the runs.
    verts, faces, _ = _sphere(4)
    mvp = (mesh.perspective(1.0, W / H, 0.1, 10.0)
           @ mesh.look_at([0, 0, 1.9], [0, 0, 0], [0, 1, 0])).astype(
               np.float32)
    sxy, valid, edges = _jax_edges(verts, faces, mvp)
    want, got = _bin_both(sxy, valid, edges, tile_w, 8, 4096, 8, 8)
    nt = (W // tile_w) * (H // 8)
    assert got[0].shape == want[0].shape
    live = want[0] >> tr.IDX_BITS < nt
    assert live.sum() > len(faces)
    np.testing.assert_array_equal(got[0][live], want[0][live])
    assert (got[0][~live] >> tr.IDX_BITS == nt).all()
    for name, a, b in zip(("starts", "counts", "overflow"), want[1:],
                          got[1:]):
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert not bool(got[3])


def _split_scene(kind):
    if kind == "icosphere4":
        verts, faces, _ = _sphere(4)
        mvp = (mesh.perspective(1.0, W / H, 0.1, 10.0)
               @ mesh.look_at([0, 0, 1.9], [0, 0, 0], [0, 1, 0]))
        return verts, faces.astype(np.int64), mvp.astype(np.float32)
    # the mixed-size triangles of
    # test_raster3d.test_split_emission_pair_set_exact
    rng = np.random.default_rng(11)
    n = 4200
    cx = rng.uniform(-0.95, 0.95, n)
    cy = rng.uniform(-0.95, 0.95, n)
    w_ = rng.uniform(0.002, 0.25, n)
    h_ = rng.uniform(0.002, 0.25, n)
    verts = np.zeros((n * 3, 3), np.float32)
    verts[0::3] = np.stack([cx - w_, cy - h_, np.full(n, 0.5)], 1)
    verts[1::3] = np.stack([cx + w_, cy - h_, np.full(n, 0.5)], 1)
    verts[2::3] = np.stack([cx, cy + h_, np.full(n, 0.5)], 1)
    return (verts, np.arange(n * 3).reshape(n, 3),
            np.eye(4, dtype=np.float32))


@pytest.mark.parametrize("kind", ["random4200", "icosphere4"])
def test_split_emission_pair_set_exact(kind):
    # mirror of test_raster3d.test_split_emission_pair_set_exact: the
    # split emission (base box + tall top-k piece) yields exactly the
    # full-emission pair set
    verts, faces, mvp = _split_scene(kind)
    tri = tr.setup_triangles(torch.from_numpy(verts),
                             torch.from_numpy(faces), torch.from_numpy(mvp),
                             W, H)
    sx, vl = tri["sxy"].numpy(), tri["valid"].numpy()
    ntx, nty = (W + 7) // 8, (H + 7) // 8
    want = []
    for i in np.nonzero(vl)[0]:
        x0 = max(int(np.floor(sx[i, :, 0].min() / 8)), 0)
        x1 = min(int(np.floor(sx[i, :, 0].max() / 8)), ntx - 1)
        y0 = max(int(np.floor(sx[i, :, 1].min() / 8)), 0)
        y1 = min(int(np.floor(sx[i, :, 1].max() / 8)), nty - 1)
        for ty in range(y0, y1 + 1):
            for tx in range(x0, x1 + 1):
                want.append(((ty * ntx + tx) << tr.IDX_BITS) | i)
    want = np.sort(np.array(want, np.int64))
    sp, st, ct, ovf = tr.bin_triangles_flat(tri["sxy"], tri["valid"], W, H,
                                            8, 8, 4096, 24, 24)
    assert not bool(ovf)
    sp = sp.numpy()
    got = sp[sp >> tr.IDX_BITS < ntx * nty]
    np.testing.assert_array_equal(np.sort(got.astype(np.int64)), want)
    np.testing.assert_array_equal(ct.numpy(),
                                  np.bincount(want >> tr.IDX_BITS,
                                              minlength=ntx * nty))


def test_bin_overflow_flag():
    # mirror of test_raster3d.test_bin_overflow_flag: 60 coincident
    # triangles in one tile with capacity 16 must overflow, in the port
    # as in the JAX flat binning
    verts = np.tile(np.array([[-0.1, -0.1, 0.5], [0.1, -0.1, 0.5],
                              [0.0, 0.1, 0.5]], np.float32), (60, 1))
    faces = np.arange(180).reshape(60, 3)
    eye = np.eye(4, dtype=np.float32)
    tq = tr.setup_triangles(torch.from_numpy(verts),
                            torch.from_numpy(faces), torch.from_numpy(eye),
                            W, H)
    _, _, counts, ovf = tr.bin_triangles_flat(tq["sxy"], tq["valid"], W, H,
                                              16, 8, 16)
    assert bool(ovf) and int(counts.max()) == 60
    tj = jr.setup_triangles(jnp.asarray(verts), jnp.asarray(faces, jnp.int32),
                            jnp.asarray(eye), W, H)
    assert bool(_jax_bin(tj["sxy"], tj["valid"], W, H, 16, 8, 16)[3])
    # and one tile's worth fits
    _, _, _, ovf_ok = tr.bin_triangles_flat(tq["sxy"], tq["valid"], W, H,
                                            16, 8, 64)
    assert not bool(ovf_ok)


def test_float_to_int_matches_xla():
    # the binning's floor -> int32 converts as XLA does: truncation,
    # saturation out of range, NaN -> 0
    x = np.array([1e12, -1e12, np.nan, 3.7, -3.7, 2.0 ** 31, -2.0 ** 31,
                  np.inf, -np.inf, 0.0], np.float32)
    np.testing.assert_array_equal(tr._to_i32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.asarray(x).astype(
                                      jnp.int32)))
