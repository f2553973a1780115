"""The split walk of K1 and K3 (``csrc/tile_raster.cu``), as a plain
mirror on the CPU: each tile's run cut into items of at most S slots
(one item up to S), each item's minimum key over its own slots, the
minima merged by ``min`` (the kernel's atomicMin), the winner's row found
again from ``key & IDX_MASK`` and its edges recomputed, then K1's and
K3's epilogues.  Keys are unique within a tile (their low bits are the
run slot), so the merged minimum is the walk's strict sequential
minimum for every S; these tests hold the mirror to the plain versions
``raster_tiles_flat_u8_reference`` and ``raster_tiles_tex_u8_reference``
bit for bit, for the kernel's S (``tile_raster.SEG``) and others around
it, on seeded runs at the split's boundaries (1, S, S + 1, 2S, 2S + 1
and 1024 slots), a run whose reads run off the pair array (an
overflowed run), NaN rows, and ``mesh_10k`` at a small frame (the
affine planes of the MMA walk and the claim grain of K1-wf are held by
tests/test_torch_mma_walk.py with this mirror, K2b's texel index and
K6's rows gathered in pair order by tests/test_torch_walk_rows_idx.py,
K2a's keys and float attributes with its warp-box cull over pairs by
tests/test_torch_walk_keys.py).
Also the plan's item list at the kernel's S: every slot of every run
walked by exactly one item, no item for an empty run, long tiles' items
first, within the capacity the wrapper allocates (``_split_scratch``,
one frame or several).

K5 on the same walk: its runs are bins rows (slot j of tile t is
``bins[t, j]``, a run walks min(counts[t], K) slots), its outputs K2a's
keys and four float attributes, and each warp of its blocks walks only
the rows the cull keeps for its box (``tile_raster.warp_boxes``,
``tile_raster.cull_keep``).  The mirror (:func:`bins_split_walk`) is held
to ``raster_tiles_bins_f32_reference`` bit for bit, keys and float bits,
with and without the cull, for S in 1..128, on runs of 1, 64, 65, 128,
129, K and more than K slots (an overflowed bins row) with NaN rows and
knife-edge triangles (``testing.crafted_bins``), one frame and 4 in one
launch, at 128x16 (16x16 warp boxes), 128x32 and 20x8 (another width:
the row-major layout, no cull), and on ``mesh_10k``.  The plan for bins walks every slot once within
B * nt * ceil(K / S) items.  The cull's predicate is held by hypothesis
never to skip a (row, box) where the walk covers a pixel.  The kernel
itself is held to the plain versions on the card by ``chip_smoke.py``
(phases 3, 10 and 13).
"""

import functools
import re
from pathlib import Path


import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from libnativecpurenderer_tpu_torch import interop
from libnativecpurenderer_tpu_torch.models import mesh
from libnativecpurenderer_tpu_torch.ops import raster3d as r3
from libnativecpurenderer_tpu_torch.ops import tile_raster as tt
from libnativecpurenderer_tpu_torch.testing import (crafted_bins,
                                                    crafted_runs,
                                                    knife_edge_rows)

torch.set_num_threads(1)

SEGS = [1, 7, 32, 64, 128]
TEX = torch.from_numpy(np.random.default_rng(5).integers(
    0, 256, (48, 64, 4)).astype(np.uint8))
BGP = tt.pack_bg(torch.tensor([0.2, 0.4, 0.6, 0.0]))


def plan(counts, seg: int, cap=None):
    """The plan kernel's list: (items [(tile, lo, hi)], long tiles'
    first, and each tile's item count).  An empty run is no item: the
    plan writes its tile's background itself.  With ``cap``, the item
    list's capacity: a list that would not fit (runs that overlap, or a
    K6 frame whose runs end past its rows) turns the split off, and every
    tile whose run is not empty is one item of its whole run."""
    counts = counts.reshape(-1).tolist()
    long_items, short_items, k_of = [], [], []
    for b, c in enumerate(counts):
        k = 0 if c <= 0 else 1 if c <= seg else -(-c // seg)
        k_of.append(k)
        for s in range(k):
            lo = s * seg if k > 1 else 0
            hi = c if s == k - 1 else lo + seg
            (long_items if k > 1 else short_items).append((b, lo, hi))
    if cap is not None and len(long_items) + len(short_items) > cap:
        whole = [(b, 0, c) for b, c in enumerate(counts) if c > 0]
        return ([i for i in whole if i[2] > seg]
                + [i for i in whole if i[2] <= seg],
                [min(k, 1) for k in k_of])
    return long_items + short_items, k_of


def _pixels(b, nt, width, tile_w, tile_h):
    t = b % nt
    ntx = (width + tile_w - 1) // tile_w
    p = torch.arange(tile_w * tile_h)
    x = (t % ntx * tile_w + p % tile_w).float()
    y = (t // ntx * tile_h + p // tile_w).float()
    return x, y


def _rows(sorted_pad, starts, table, b, nt, slots):
    """Rows of slots ``slots`` of tile b's run: through the pair array
    (PAIRS), or with ``sorted_pad`` None straight from ``table``, the
    rows gathered in pair order (K6's ROWS), clamped below their count."""
    f = b // nt
    nrows = table.shape[-2]
    if sorted_pad is None:
        idx = (starts.reshape(-1)[b] + slots).clamp(max=nrows - 1)
        return table.reshape(-1, nrows, tt.ROW_W)[f][idx.long()]
    spad = sorted_pad.shape[-1]
    idx = (starts.reshape(-1)[b] + slots).clamp(max=spad - 1)
    tri = (sorted_pad.reshape(-1, spad)[f][idx.long()] & r3.IDX_MASK).clamp(
        max=nrows - 1)
    return table.reshape(-1, nrows, tt.ROW_W)[f][tri.long()]


def claim_sequence(n_items, wf, seed):
    """The order in which blocks walk the plan's items when each claims
    ``wf`` consecutive items and walks them in list order: the claims
    interleaved at random (``seed``; None: list order), as blocks that
    run side by side finish them."""
    claims = [list(range(c, min(c + wf, n_items)))
              for c in range(0, n_items, wf)]
    if seed is None:
        return [i for c in claims for i in c]
    rng = np.random.default_rng(seed)
    out = []
    while claims:
        k = int(rng.integers(len(claims)))
        out.append(claims[k].pop(0))
        if not claims[k]:
            claims.pop(k)
    return out


def item_minima(sorted_pad, starts, counts, table, width, tile_w, tile_h,
                z_clip, seg, mxu=0, cap=None, cull=False):
    """(items, each tile's item count, each item's minimum key (P,)): the
    walk of one item over its own slots, on the CUDA cores' planes (the
    FMA walk) or, with ``mxu``, on the affine planes of the MMA walk
    (``mxu=2`` rounding the table and the coordinates to bfloat16, as the
    plain version does); the items of :func:`plan` with capacity
    ``cap``.  ``sorted_pad`` None: the runs index ``table`` (ROWS).  With
    ``cull`` (K2a at tiles 128 wide) a pixel sees only the rows
    ``tile_raster.cull_keep`` keeps for its warp's box
    (``tile_raster.warp_boxes``; other widths cull nothing)."""
    nt = counts.shape[-1]
    if mxu == 2:
        table = tt.bf16_round(table)
    layout = tt.warp_boxes(tile_w, tile_h) if cull else None
    items, k_of = plan(counts, seg, cap)
    minima = []
    for b, lo, hi in items:
        x, y = _pixels(b, nt, width, tile_w, tile_h)
        if mxu == 2:
            x, y = tt.bf16_round(x), tt.bf16_round(y)
        slots = torch.arange(lo, hi, dtype=torch.int32)
        r = _rows(sorted_pad, starts, table, b, nt, slots)[:, None, :]
        if mxu:
            e0, e1, e2, zz = (tt._affine(r, x, y, q) for q in range(4))
        else:
            e0, e1, e2 = tt._edges(r, x, y)
            zz = e0 * r[..., 9] + e1 * r[..., 10] + e2 * r[..., 11]
        cov = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        if z_clip:
            cov = cov & (zz >= 0.0) & (zz <= 1.0)
        if layout is not None:
            keep = tt.cull_keep(r, _warp_box(b, nt, width, tile_w, tile_h))
            cov = cov & keep[:, layout[1]]
        keys = ((zz * r3.Z_LEVELS).to(torch.int32) << r3.IDX_BITS) \
            | slots[:, None]
        keys = torch.where(cov, keys, r3.SKY_KEY)
        minima.append(keys.amin(0))
    return items, k_of, minima


def split_walk(sorted_pad, starts, counts, table, width, tile_w, tile_h,
               z_clip, seg, mxu=0, wf=1, order=None, minima=None,
               cap=None, cull=False):
    """(best keys (NB, P), attr) of the split walk: per item its minimum
    key, the items walked in the order blocks claiming ``wf`` at a time
    reach them (:func:`claim_sequence` with seed ``order``), merged by
    min, each tile's keys taken when its last item arrives (the kernel's
    arrival counter); attr(d) the winners' attribute d recomputed from
    their rows: the interpolated attribute (FMA walk) or, with ``mxu``,
    the affine plane 4 + d.  ``minima`` is :func:`item_minima`'s result
    for these inputs, when the caller has it; ``cap`` the item list's
    capacity (:func:`plan`); ``sorted_pad`` None: the runs index
    ``table``, rows gathered in pair order (K6's ROWS source); ``cull``
    K2a's warp-box cull (:func:`item_minima`)."""
    nt = counts.shape[-1]
    nb = counts.numel()
    P = tile_w * tile_h
    if minima is None:
        minima = item_minima(sorted_pad, starts, counts, table, width,
                             tile_w, tile_h, z_clip, seg, mxu, cap, cull)
    items, k_of, item_min = minima
    merged = torch.full((nb, P), r3.SKY_KEY, dtype=torch.int32)
    best = merged.clone()
    arrived = [0] * nb
    for i in claim_sequence(len(items), wf, order):
        b = items[i][0]
        merged[b] = torch.minimum(merged[b], item_min[i])
        arrived[b] += 1
        if arrived[b] == k_of[b]:   # the last item runs the epilogue
            best[b] = merged[b]
    assert arrived == k_of
    slot = torch.where(best != r3.SKY_KEY, best & r3.IDX_MASK, 0)
    xs, ys, rows = [], [], []
    for b in range(nb):
        x, y = _pixels(b, nt, width, tile_w, tile_h)
        xs.append(x)
        ys.append(y)
        rows.append(_rows(sorted_pad, starts, table, b, nt, slot[b]))
    X, Y, R = torch.stack(xs), torch.stack(ys), torch.stack(rows)
    best = best.reshape(counts.shape + (P,))
    if mxu:
        if mxu == 2:
            X, Y, R = tt.bf16_round(X), tt.bf16_round(Y), tt.bf16_round(R)
        return best, lambda d: tt._affine(R, X, Y, 4 + d)
    e = tt._edges(R, X, Y)
    return best, lambda d: tt._channel(R, e, d)


def _boundary_case(seg, past_end=0):
    lengths = [1, seg, seg + 1, 2 * seg, 2 * seg + 1, 1024]
    return crafted_runs(lengths, seed=seg, past_end=past_end)


def _mesh_case():
    v, f, c = mesh.mesh_10k()
    verts, faces, colors = interop.mesh_to_torch(v, f, c, "cpu",
                                                 torch.float32)
    m = (mesh.perspective(1.0, 256 / 160, 0.1, 10.0)
         @ mesh.look_at([0.0, 0.6, 3.2], [0, 0, 0], [0, 1, 0])
         @ mesh.rotation_y(0.45)).astype(np.float32)
    prep = r3.prepare_frame(verts, faces, colors, 256, 160,
                            torch.from_numpy(m), tile_w=32, tile_h=32,
                            capacity=4096, span_x=9, span_y=6, z_clip=True)
    assert not bool(prep["overflow"])
    return (prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"], 256)


CASES = {"boundaries": lambda s: _boundary_case(s),
         "past the pair array": lambda s: _boundary_case(s, past_end=300),
         "mesh_10k": lambda s: _mesh_case()}


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("case", list(CASES))
def test_split_u8_equals_plain_walk(case, seg):
    sp, st, ct, table, width = CASES[case](seg)
    if case == "boundaries":
        assert int(torch.isnan(table[:-1, 0]).sum()) > 0
    for opaque, z_clip in ((True, False), (False, True)):
        best, attr = split_walk(sp, st, ct, table, width, 32, 32, z_clip,
                                seg)
        got = tt._u8_epilogue(best, attr, BGP, opaque)
        want = tt.raster_tiles_flat_u8_reference(
            sp, st, ct, table, BGP, width, 32, 32, opaque=opaque,
            z_clip=z_clip)
        assert (want != BGP).float().mean() > 0.2
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("case", list(CASES))
def test_split_tex_u8_equals_plain_walk(case, seg):
    sp, st, ct, table, width = CASES[case](seg)
    packed = r3.pack_texture_u8(TEX)
    best, attr = split_walk(sp, st, ct, table, width, 32, 32, True, seg)
    got = tt._tex_u8_epilogue(best, attr, packed, (48, 64), BGP)
    want = tt.raster_tiles_tex_u8_reference(sp, st, ct, table, packed,
                                            (48, 64), BGP, width, 32, 32,
                                            z_clip=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _frames(seeds):
    """Boundary cases at the kernel's S from several seeds, stacked as
    B frames (a leading B on each input, as a batched launch takes)."""
    cases = [crafted_runs([1, tt.SEG, tt.SEG + 1, 2 * tt.SEG,
                           2 * tt.SEG + 1, 1024], seed=s) for s in seeds]
    return tuple(torch.stack([c[i] for c in cases]) for i in range(4))


PLAN_CASES = {
    "boundaries": lambda: CASES["boundaries"](tt.SEG)[:4],
    "past the pair array":
        lambda: CASES["past the pair array"](tt.SEG)[:4],
    "mesh_10k": lambda: _mesh_case()[:4],
    "3 frames": lambda: _frames([1, 2, 3])}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_walks_every_slot_once_within_capacity(case):
    # the item list the plan kernel writes fits the wrapper's scratch
    # when the runs partition each frame's pairs, as the binning's do, so
    # the split is on for the main path (here also with a run read 300
    # slots past the pair array, which the array's padding absorbs)
    sp, st, ct, table = PLAN_CASES[case]()
    _, cap, _ = tt._split_scratch(sp, ct, table)
    items, k_of = plan(ct, tt.SEG)
    assert len(items) <= cap
    assert cap >= ct.numel()
    walked = {}
    for b, lo, hi in items:
        assert hi - lo <= tt.SEG or k_of[b] == 1
        walked.setdefault(b, []).extend(range(lo, hi))
    for b, c in enumerate(ct.reshape(-1).tolist()):
        assert sorted(walked.get(b, [])) == list(range(c))
        assert (b in walked) == (c > 0)
    n_long = sum(k for k in k_of if k > 1)
    assert n_long > 0
    assert all(k_of[b] > 1 for b, _, _ in items[:n_long])
    assert all(k_of[b] == 1 for b, _, _ in items[n_long:])


@pytest.mark.parametrize("name,value", [("THREADS", 32 * tt.WARPS),
                                        ("BOX_W", tt.BOX_W)])
def test_k5_layout_constants_are_the_kernels(name, value):
    # warp_boxes and bins_cull_keep mirror the kernel's warps a block and
    # its warp boxes' width
    src = (Path(tt.__file__).resolve().parent.parent / "csrc"
           / "tile_raster.cu").read_text()
    assert re.findall(rf"constexpr int {name} = (\d+);", src) == [str(value)]


def test_seg_is_the_kernels():
    # the wrapper sizes the item list with SEG; the kernel cuts runs at
    # its own compile-time SEG
    src = (Path(tt.__file__).resolve().parent.parent / "csrc"
           / "tile_raster.cu").read_text()
    assert re.findall(r"constexpr int SEG = (\d+);", src) == [str(tt.SEG)]


# ---- K5: the split walk over bins, with the warp boxes' cull ----

def _bin_rows(bins, table, b, nt, slots):
    """Rows of slots ``slots`` of tile b's bins row (K5's ``row_of``)."""
    K, nrows = bins.shape[-1], table.shape[-2]
    tri = bins.reshape(-1, K)[b][slots.long()].clamp(0, nrows - 1)
    return table.reshape(-1, nrows, tt.ROW_W)[b // nt][tri.long()]


def _warp_box(b, nt, width, tile_w, tile_h):
    """(WARPS, 4) float32 boxes of tile b's warps, frame coordinates."""
    t = b % nt
    ntx = (width + tile_w - 1) // tile_w
    ox, oy = t % ntx * tile_w, t // ntx * tile_h
    boxes, _ = tt.warp_boxes(tile_w, tile_h)
    return (boxes + torch.tensor([ox, ox, oy, oy])).float()


def bins_split_walk(bins, counts, table, width, tile_w, tile_h, seg,
                    cull=True, order=None):
    """(best keys, attr) of K5's split walk: each run of min(counts, K)
    bin slots cut into items by :func:`plan`, each item's minimum key
    over its own slots with the z test on, where with ``cull`` a pixel
    sees only the rows ``tile_raster.cull_keep`` keeps for its warp's box
    (``tile_raster.warp_boxes``; at widths other than 128 the kernel
    culls nothing); the items merged by min in the order
    blocks reach them (:func:`claim_sequence`), a tile's keys taken when
    its last item arrives; attr(d) the winners' attribute d recomputed
    from their rows.  Also returns the kept share of (row, warp)
    pairs."""
    nt, K = counts.shape[-1], bins.shape[-1]
    nb, P = counts.numel(), tile_w * tile_h
    n_walk = counts.reshape(-1).clamp(max=K)
    items, k_of = plan(n_walk, seg)
    cull = cull and tt.warp_boxes(tile_w, tile_h) is not None
    if cull:
        _, warp = tt.warp_boxes(tile_w, tile_h)
    merged = torch.full((nb, P), r3.SKY_KEY, dtype=torch.int32)
    best = merged.clone()
    arrived = [0] * nb
    kept = [0, 0]
    for i in claim_sequence(len(items), 1, order):
        b, lo, hi = items[i]
        x, y = _pixels(b, nt, width, tile_w, tile_h)
        slots = torch.arange(lo, hi, dtype=torch.int32)
        r = _bin_rows(bins, table, b, nt, slots)[:, None, :]
        e0, e1, e2 = tt._edges(r, x, y)
        zz = e0 * r[..., 9] + e1 * r[..., 10] + e2 * r[..., 11]
        cov = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (zz >= 0.0)
               & (zz <= 1.0))
        if cull:
            keep = tt.cull_keep(r, _warp_box(b, nt, width, tile_w, tile_h))
            kept[0] += int(keep.sum())
            kept[1] += keep.numel()
            cov = cov & keep[:, warp]
        keys = ((zz * r3.Z_LEVELS).to(torch.int32) << r3.IDX_BITS) \
            | slots[:, None]
        keys = torch.where(cov, keys, r3.SKY_KEY)
        merged[b] = torch.minimum(merged[b], keys.amin(0))
        arrived[b] += 1
        if arrived[b] == k_of[b]:
            best[b] = merged[b]
    assert arrived == k_of
    slot = torch.where(best != r3.SKY_KEY, best & r3.IDX_MASK, 0)
    xs, ys, rows = [], [], []
    for b in range(nb):
        x, y = _pixels(b, nt, width, tile_w, tile_h)
        xs.append(x)
        ys.append(y)
        rows.append(_bin_rows(bins, table, b, nt, slot[b]))
    X, Y, R = torch.stack(xs), torch.stack(ys), torch.stack(rows)
    e = tt._edges(R, X, Y)
    share = kept[0] / kept[1] if kept[1] else 1.0
    return (best.reshape(counts.shape + (P,)),
            lambda d: tt._channel(R, e, d), share)


K5_K = 160
K5_LENGTHS = [1, tt.SEG, tt.SEG + 1, 2 * tt.SEG, 2 * tt.SEG + 1, K5_K,
              K5_K + 37]


def _bins_frames(seeds, tile_w, tile_h):
    """crafted_bins at K5_LENGTHS for several seeds, stacked as B frames."""
    cases = [crafted_bins(K5_LENGTHS, K5_K, tile_w, tile_h, seed=s)
             for s in seeds]
    return tuple(torch.stack([c[i] for c in cases]) for i in range(3)) + (
        cases[0][3],)


def _bins_mesh_case():
    v, f, c = mesh.mesh_10k()
    verts, faces, colors = interop.mesh_to_torch(v, f, c, "cpu",
                                                 torch.float32)
    m = (mesh.perspective(1.0, 256 / 160, 0.1, 10.0)
         @ mesh.look_at([0.0, 0.6, 3.2], [0, 0, 0], [0, 1, 0])
         @ mesh.rotation_y(0.45)).astype(np.float32)
    tri, attrs, edges = r3._setup_edges(verts, faces, torch.from_numpy(m),
                                        256, 160, attrs=colors[faces])
    bins, counts, ovf = r3.bin_triangles(tri["sxy"], edges[-1], 256, 160,
                                         128, 16, 2048, 2, 10)
    assert not bool(ovf)
    bins = torch.where(bins == r3.NO_TRI, faces.shape[0], bins)
    return bins, counts, tt.build_table(*edges, attrs), 256


BINS_CASES = {
    "boundaries 128x16": lambda: crafted_bins(K5_LENGTHS, K5_K, 128, 16),
    "boundaries 128x32": lambda: crafted_bins(K5_LENGTHS, K5_K, 128, 32,
                                              seed=3),
    "boundaries 20x8": lambda: crafted_bins(K5_LENGTHS, K5_K, 20, 8,
                                            seed=4),
    "4 frames 128x16": lambda: _bins_frames([5, 6, 7, 8], 128, 16),
    "mesh_10k": _bins_mesh_case}
BINS_TILES = {"boundaries 128x32": (128, 32), "boundaries 20x8": (20, 8)}


@functools.lru_cache(maxsize=None)
def _bins_case(case):
    return BINS_CASES[case]()


@functools.lru_cache(maxsize=None)
def _bins_reference(case):
    bins, counts, table, width = _bins_case(case)
    tw, th = BINS_TILES.get(case, (128, 16))
    return tt.raster_tiles_bins_f32_reference(bins, counts, table, width,
                                              tw, th)


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("case", list(BINS_CASES))
def test_split_bins_f32_equals_plain_walk(case, seg):
    bins, counts, table, width = _bins_case(case)
    tw, th = BINS_TILES.get(case, (128, 16))
    want_k, want_r = _bins_reference(case)
    assert (want_k != r3.SKY_KEY).float().mean() > 0.2
    if case.startswith("boundaries"):
        assert int(torch.isnan(table[:-1, 0]).sum()) > 0
        assert int(counts.max()) > bins.shape[-1]     # an overflowed row
    for cull, order in ((True, None), (False, seg)):
        best, attr, share = bins_split_walk(bins, counts, table, width, tw,
                                            th, seg, cull=cull, order=order)
        got_k, got_r = tt._keys_f32_epilogue(best, attr)
        assert torch.equal(got_k, want_k)
        assert torch.equal(got_r.view(torch.int32), want_r.view(torch.int32))
        if cull and case != "boundaries 20x8":
            assert share < 0.9     # the cull skips rows
        elif cull:
            assert share == 1.0    # no warp boxes at this width


@pytest.mark.parametrize("case", list(BINS_CASES))
def test_bins_plan_walks_every_slot_once_within_capacity(case):
    # a bins run walks min(count, K) slots, so the plan's list always fits
    # B * nt * ceil(K / S) items: the split is always on for K5
    bins, counts, table, _ = _bins_case(case)
    K = bins.shape[-1]
    _, cap, _ = tt._split_scratch(bins, counts, table, bins=True)
    assert cap == counts.numel() * -(-K // tt.SEG)
    n_walk = counts.reshape(-1).clamp(max=K)
    items, k_of = plan(n_walk, tt.SEG)
    assert len(items) <= cap
    walked = {}
    for b, lo, hi in items:
        assert hi - lo <= tt.SEG
        walked.setdefault(b, []).extend(range(lo, hi))
    for b, c in enumerate(n_walk.tolist()):
        assert sorted(walked.get(b, [])) == list(range(c))
    assert int(counts.max()) <= K or max(k_of) == -(-K // tt.SEG)


def _box_covered(rows, box):
    """(rows, boxes) bool: whether the walk's own edges (e >= 0, the
    expression of ``tile_raster._edges``) cover a pixel of each box."""
    out = torch.zeros((rows.shape[0], box.shape[0]), dtype=torch.bool)
    for k, (x0, x1, y0, y1) in enumerate(box.tolist()):
        ys, xs = torch.meshgrid(torch.arange(y0, y1 + 1.0),
                                torch.arange(x0, x1 + 1.0), indexing="ij")
        e0, e1, e2 = tt._edges(rows[:, None, :], xs.reshape(-1),
                               ys.reshape(-1))
        out[:, k] = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)).any(1)
    return out


@pytest.mark.parametrize("tile", [(128, 16), (128, 32), (128, 8)])
@pytest.mark.parametrize("seed", range(3))
def test_cull_never_skips_a_covered_box_knife_edges(tile, seed):
    # knife-edge triangles (an edge through pixel coordinates on a warp
    # box's border, coefficients scaled from 2^-60 to 2^60, NaN rows):
    # a culled (row, box) is never covered, and the test does cull boxes
    # whose neighbour the same edge covers (a row with a NaN coefficient
    # may be culled by another edge or walked: it never covers)
    tw, th = tile
    ox = 128 * (3 + seed)
    rows = knife_edge_rows(tw, th, ox, 200, seed=100 + seed)
    box = _warp_box(0, 1, 4096, tw, th) + torch.tensor(
        [ox, ox, 0, 0], dtype=torch.float32)
    keep = tt.cull_keep(rows[:, None, :], box[None])
    covered = _box_covered(rows, box)
    assert not bool((covered & ~keep).any())
    near = (~keep[:, 1:] & covered[:, :-1]) | (~keep[:, :-1] & covered[:, 1:])
    assert int(near.sum()) > 0
    # the table's NaN pad row is never culled (it never covers either)
    pad = torch.full((1, 1, tt.ROW_W), float("nan"))
    assert bool(tt.cull_keep(pad, box[None]).all())


_MANT = st.one_of(st.floats(-8.0, 8.0, width=32),
                  st.sampled_from([0.0, -0.0, 1.0, -1.0, 0.5, -3.0]))


@settings(max_examples=400, deadline=None, database=None)
@given(data=st.data())
def test_cull_never_skips_a_covered_box(data):
    # any float32 edges, each through (or within a hair of) a pixel on
    # the border of a 16x16 box, scaled by 2^-100 .. 2^100, a NaN now and
    # then: where the cull skips the box, the walk covers none of it
    bx = 16 * data.draw(st.integers(0, 119))
    by = 16 * data.draw(st.integers(0, 66))
    box = torch.tensor([[bx, bx + 15, by, by + 15]], dtype=torch.float32)
    row = torch.zeros(1, tt.ROW_W, dtype=torch.float32)
    for i in range(3):
        a, b = data.draw(_MANT), data.draw(_MANT)
        scale = 2.0 ** data.draw(st.integers(-100, 100))
        xb = bx + data.draw(st.sampled_from([-1, 0, 15, 16, 7]))
        yb = by + data.draw(st.sampled_from([-1, 0, 15, 16, 9]))
        hair = data.draw(st.sampled_from([0.0, 1e-7, -1e-7, 3e-4, -3e-4]))
        c = -(np.float64(a) * xb + np.float64(b) * yb) + hair
        vals = [a * scale, b * scale, c * scale]
        if data.draw(st.integers(0, 30)) == 0:
            vals[data.draw(st.integers(0, 2))] = float("nan")
        row[0, 3 * i:3 * i + 3] = torch.tensor(vals, dtype=torch.float32)
    keep = tt.cull_keep(row[:, None, :], box[None])
    if not bool(keep.all()):
        assert not bool(_box_covered(row, box).any())
