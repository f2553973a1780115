"""The MMA walk of K1-mxu and K3's mxu walk (``csrc/tile_raster.cu``) and
the claim grain of K1-wf, on the CPU.

(a) The walk's operands, :func:`tile_raster.mma_operands`, the plain
counterpart of the kernel's ``a_frag`` and ``build_b``: every value of A
and B a bfloat16; the parts exact (x = xh + xl, a = a0 + a1 + a2 for
``mxu=1``; one bf16 pass for ``mxu=2``); in float64, A @ B holds plane
2 (i % 2) + c % 2 of triangle 16 s + 4 (i // 2) + c // 2 at column
64 s + 8 i + c, each exactly (a_x x + a_y y) + c of the float32 (or, with
``mxu=2``, bf16-rounded) coefficients and coordinates (``math.fsum`` of
the exact products against that of the exact terms); the columns a lane
of a quad holds are whole triangles; NaN rows and the pad columns past
the last triangle are NaN planes; and the probe's plain version
(``testing.mma_probe_plain``) is that product.  Checked on ``mesh_10k``'s
affine rows at a tile far from the origin (coordinates that need both
bf16 parts), seeded rows of many magnitudes, and rows with NaN.

(b) The split walk's plain mirror (``test_torch_walk_split.split_walk``)
with the affine planes and a claim grain: for each S of ``SEGS``, wf in
1, 2, 8 and NT (the case's tiles) and two shuffled interleavings of the
claims (blocks finishing side by side), the keys and u8 frames of the
mirror equal those of ``raster_tiles_flat_u8_mxu_reference`` (keys: its
walk, ``tile_raster._pairs_walk``) for ``mxu`` 1 and 2 and of
``raster_tiles_tex_u8_mxu_reference``, and the FMA mirror's equal K1's
plain version, bit for bit, on the split boundaries' runs (affine tables
of the same seeded triangles).  The merge is exact in any order because
keys are unique in a tile.

The kernel itself is held to these on the card by ``chip_smoke.py`` (the
probe phase and phase 16).
"""

import functools
import math

import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu_torch import interop
from libnativecpurenderer_tpu_torch.models import mesh
from libnativecpurenderer_tpu_torch.ops import raster3d as r3
from libnativecpurenderer_tpu_torch.ops import tile_raster as tt
from libnativecpurenderer_tpu_torch import testing
from libnativecpurenderer_tpu_torch.testing import crafted_runs
from test_torch_walk_split import SEGS, item_minima, split_walk

torch.set_num_threads(1)

TEX = torch.from_numpy(np.random.default_rng(6).integers(
    0, 256, (40, 56, 4)).astype(np.uint8))
BGP = tt.pack_bg(torch.tensor([0.3, 0.5, 0.7, 0.0]))


@functools.lru_cache(maxsize=None)
def _mesh_rows():
    """``mesh_10k``'s affine rows (NaN rows among them) at 1920x1080."""
    v, f, c = mesh.mesh_10k()
    verts, faces, colors = interop.mesh_to_torch(v, f, c, "cpu",
                                                 torch.float32)
    m = (mesh.perspective(1.0, 1920 / 1080, 0.1, 10.0)
         @ mesh.look_at([0.0, 0.6, 3.2], [0, 0, 0], [0, 1, 0])
         @ mesh.rotation_y(0.45)).astype(np.float32)
    tri = r3.setup_triangles(verts, faces, torch.from_numpy(m), 1920, 1080)
    A, B, C, ia, sg, vl = r3.edge_coeffs(tri["sxy"], tri["z"], tri["valid"])
    return tt.build_table_mxu(A, B, C, tri["z"] * ia[:, None], ia, sg, vl,
                              colors[faces])


def _seeded_rows():
    """40 rows of coefficients over magnitudes 2^-20 .. 2^20."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((40, tt.ROW_W)) * 2.0 ** rng.integers(
        -20, 21, (40, tt.ROW_W))
    return torch.from_numpy(v.astype(np.float32))


ROWS = {"mesh_10k": lambda: _mesh_rows()[:-1][::97][:48].contiguous(),
        "seeded": _seeded_rows,
        "13 rows": lambda: _mesh_rows()[:-1][::211][:13].contiguous()}
# a tile far from the origin: x = 1792 + p % 32 needs both bf16 parts
X = (1792 + torch.arange(128) % 32).float()
Y = (1000 + torch.arange(128) // 32).float()


@pytest.mark.parametrize("mxu", [1, 2])
@pytest.mark.parametrize("rows", list(ROWS))
def test_operands_are_exact_bf16_parts(rows, mxu):
    r = ROWS[rows]()
    A, B, cols = tt.mma_operands(r, X, Y, mxu)
    n = -(-r.shape[0] // 16)
    assert A.shape == (128, 16) and B.shape == (16, 64 * n)
    assert cols.shape == (64 * n, 2)
    for m in (A, B):
        fin = torch.isfinite(m)
        assert torch.equal(tt.bf16_round(m)[fin], m[fin])
    # x = xh + xl (mxu=2: xh alone, the rounded coordinate) and K's shape
    xs = X if mxu == 1 else tt.bf16_round(X)
    ys = Y if mxu == 1 else tt.bf16_round(Y)
    assert torch.equal(A[:, 0].double() + A[:, 1].double(), xs.double())
    assert torch.equal(A[:, 6].double() + A[:, 7].double(), ys.double())
    for k in (2, 4):
        assert torch.equal(A[:, k:k + 2], A[:, :2])
        assert torch.equal(A[:, 6 + k:8 + k], A[:, 6:8])
    assert (A[:, 12:15] == 1).all() and (A[:, 15] == 0).all()
    assert (B[15] == 0).all()
    if mxu == 2:
        assert (A[:, 1] == 0).all() and (A[:, 7] == 0).all()
    # a = a0 + a1 + a2 exactly, for each coefficient of each live column
    t, pl = cols[:, 0], cols[:, 1]
    live = t < r.shape[0]
    coef = r if mxu == 1 else tt.bf16_round(r)
    for m, ks in enumerate(([0, 2, 4], [6, 8, 10], [12, 13, 14])):
        want = coef[t[live], 4 * pl[live] + m].double()
        got = B[ks][:, live].double().sum(0)
        ok = torch.isfinite(want)
        assert torch.equal(got[ok], want[ok])
        assert torch.isnan(got[~ok]).all()
        if m < 2:   # each part twice, against xh and xl
            torch.testing.assert_close(B[[k + 1 for k in ks]], B[ks],
                                       rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mxu", [1, 2])
@pytest.mark.parametrize("rows", list(ROWS))
def test_product_puts_each_plane_at_its_column(rows, mxu):
    r = ROWS[rows]()
    A, B, cols = tt.mma_operands(r, X, Y, mxu)
    # the column layout, computed here from its definition
    n = np.arange(B.shape[1])
    s_, i, c = n // 64, (n % 64) // 8, n % 8
    np.testing.assert_array_equal(cols[:, 0].numpy(),
                                  16 * s_ + 4 * (i // 2) + c // 2)
    np.testing.assert_array_equal(cols[:, 1].numpy(),
                                  2 * (i % 2) + c % 2)
    D = A.double() @ B.double()
    coef = r if mxu == 1 else tt.bf16_round(r)
    xs = X if mxu == 1 else tt.bf16_round(X)
    ys = Y if mxu == 1 else tt.bf16_round(Y)
    T = r.shape[0]
    for col in range(B.shape[1]):
        t, pl = int(cols[col, 0]), int(cols[col, 1])
        if t >= T or not torch.isfinite(coef[t, 4 * pl:4 * pl + 3]).all():
            assert torch.isnan(D[:, col]).all()
            continue
        ax, ay, cc = (float(coef[t, 4 * pl + m]) for m in range(3))
        for p in range(0, 128, 9):
            x, y = float(xs[p]), float(ys[p])
            # each product exact in float64: the exact sum of the 16 terms
            # is the exact (a_x x + a_y y) + c
            terms = [float(a) * float(b) for a, b in
                     zip(A[p].double(), B[:, col].double())]
            assert math.fsum(terms) == math.fsum([ax * x, ay * y, cc])
        # every pixel, to float64's rounding of the terms' magnitude
        terms = torch.stack([coef[t, 4 * pl].double() * xs.double(),
                             coef[t, 4 * pl + 1].double() * ys.double(),
                             coef[t, 4 * pl + 2].double().expand(128)])
        err = (D[:, col] - terms.sum(0)).abs()
        assert (err <= 1e-14 * terms.abs().sum(0)).all()


def test_a_lane_holds_whole_triangles():
    # lane 4g + q holds columns 8i + 2q and + 1 of every i: the four
    # planes of triangles 4k + q, k = 0..3, of each 16-triangle operand
    _, _, cols = tt.mma_operands(_seeded_rows()[:32], X, Y, 1)
    for s_ in range(2):
        for q in range(4):
            held = {(int(cols[64 * s_ + 8 * i + 2 * q + c, 0]),
                     int(cols[64 * s_ + 8 * i + 2 * q + c, 1]))
                    for i in range(8) for c in range(2)}
            assert held == {(16 * s_ + 4 * k + q, pl) for k in range(4)
                            for pl in range(4)}


@pytest.mark.parametrize("mxu", [1, 2])
def test_probe_plain_version_is_the_product(mxu):
    r = ROWS["13 rows"]()
    got = testing.mma_probe_plain(r, 1792, 1000, 32, mxu)
    assert got.shape == (64, 16, 4)
    A, B, cols = tt.mma_operands(r, X[:64], Y[:64], mxu)
    d = (A.double() @ B.double()).float()
    for col in range(B.shape[1]):
        t, pl = int(cols[col, 0]), int(cols[col, 1])
        torch.testing.assert_close(got[:, t, pl], d[:, col], rtol=0, atol=0,
                                   equal_nan=True)
    assert torch.isnan(got[:, 13:]).all()
    with pytest.raises(ValueError):
        testing.mma_probe_plain(torch.zeros(17, tt.ROW_W), 0, 0, 32, mxu)


# (b) the split walk's mirror: affine planes and claim grains

WFS = [1, 2, 8, "NT"]
ORDERS = [11, 12]


@functools.lru_cache(maxsize=None)
def _case(seg, mxu):
    """The split boundaries' runs at S = seg (the FMA walk's edge table,
    or the affine table of the same triangles)."""
    lengths = [1, seg, seg + 1, 2 * seg, 2 * seg + 1, 1024]
    return crafted_runs(lengths, seed=seg, mxu=bool(mxu))


@functools.lru_cache(maxsize=None)
def _minima(seg, mxu, z_clip):
    sp, st, ct, table, width = _case(seg, mxu)
    return item_minima(sp, st, ct, table, width, 32, 32, z_clip, seg, mxu)


def _wf(wf, seg):
    return _case(seg, 0)[2].numel() if wf == "NT" else wf


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("wf", WFS)
@pytest.mark.parametrize("seg", SEGS)
def test_claim_grain_u8_equals_plain_walks(seg, wf, order):
    wf = _wf(wf, seg)
    for mxu, opaque, z_clip in ((0, True, False), (0, False, True),
                                (1, True, False), (1, False, True),
                                (2, False, True)):
        sp, st, ct, table, width = _case(seg, mxu)
        best, attr = split_walk(sp, st, ct, table, width, 32, 32, z_clip,
                                seg, mxu=mxu, wf=wf, order=order,
                                minima=_minima(seg, mxu, z_clip))
        got = tt._u8_epilogue(best, attr, BGP, opaque)
        if mxu:
            want = tt.raster_tiles_flat_u8_mxu_reference(
                sp, st, ct, table, BGP, width, 32, 32, opaque=opaque,
                z_clip=z_clip, mxu=mxu)
            keys, _ = tt._pairs_walk(sp, st, ct, table, width, 32, 32,
                                     z_clip, mxu)
        else:
            want = tt.raster_tiles_flat_u8_reference(
                sp, st, ct, table, BGP, width, 32, 32, opaque=opaque,
                z_clip=z_clip)
            keys, _ = tt._pairs_walk(sp, st, ct, table, width, 32, 32,
                                     z_clip)
        assert (want != BGP).float().mean() > 0.2
        torch.testing.assert_close(best, keys, rtol=0, atol=0)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("wf", WFS)
@pytest.mark.parametrize("seg", SEGS)
def test_claim_grain_tex_mxu_equals_plain_walk(seg, wf, order):
    wf = _wf(wf, seg)
    packed = r3.pack_texture_u8(TEX)
    for mxu in (1, 2):
        sp, st, ct, table, width = _case(seg, mxu)
        best, attr = split_walk(sp, st, ct, table, width, 32, 32, True, seg,
                                mxu=mxu, wf=wf, order=order,
                                minima=_minima(seg, mxu, True))
        got = tt._tex_u8_epilogue(best, attr, packed, (40, 56), BGP)
        want = tt.raster_tiles_tex_u8_mxu_reference(
            sp, st, ct, table, packed, (40, 56), BGP, width, 32, 32,
            z_clip=True, mxu=mxu)
        assert (want != BGP).float().mean() > 0.2
        torch.testing.assert_close(got, want, rtol=0, atol=0)

