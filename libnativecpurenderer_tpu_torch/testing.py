"""Seeded inputs shared by the port's CPU tests and ``chip_smoke.py``;
nothing on a render path imports this module."""

import math

import numpy as np
import torch

from .ops import raster3d, tile_raster


def crafted_uv_table(table):
    """The row table with the uv attribute columns of every valid row
    replaced by a seeded choice of: huge (x1e30), negative, a tiny or a
    zero denominator, NaN u and v; edges and z kept."""
    t = table.clone()
    ok = ~torch.isnan(t[:-1, 0])
    rows = torch.nonzero(ok).flatten()
    kind = torch.from_numpy(np.random.default_rng(9).integers(
        0, 5, rows.numel())).to(t.device)
    uv = torch.tensor([14 + 4 * i + d for i in range(3) for d in range(3)],
                      device=t.device)
    den = torch.tensor([16, 20, 24], device=t.device)
    for k, fn in enumerate((lambda x: x * 1e30, lambda x: -3.0 * x.abs())):
        r = rows[kind == k]
        t[r[:, None], uv] = fn(t[r[:, None], uv])
    t[rows[kind == 2][:, None], den] *= 1e-30
    t[rows[kind == 3][:, None], torch.tensor([14, 19],
                                             device=t.device)] = math.nan
    t[rows[kind == 4][:, None], den] = 0.0
    return t


def crafted_runs(lengths, tile_w: int = 32, tile_h: int = 32, seed: int = 0,
                 nan_share: float = 0.1, past_end: int = 0,
                 mxu: bool = False, knife: bool = False):
    """One row of ``len(lengths)`` tiles whose runs hold exactly
    ``lengths`` triangles each, for the split walk's boundaries: seeded
    triangles around their tile (most cover some of it, at depths partly
    outside [0, 1]), ``nan_share`` of them invalid (NaN rows), the pair
    array in the binning's layout (tile-major, padded to a multiple of
    64 plus two guard blocks with the pad row's pair).  ``past_end``
    slots are added to the last run's count, so its reads run off the
    pair array and are clamped, as an overflowed run's.  Returns
    (sorted_pad, starts, counts, table, width) on the CPU; the frame is
    ``width`` x ``tile_h``, its attributes in [0, 1] (the third in
    [0.5, 1.5], a texel denominator); with ``mxu`` the table is the
    matrix-unit walk's affine one (``tile_raster.build_table_mxu``) of the
    same triangles; with ``knife`` every third triangle of each run is a
    :func:`knife_edge_rows` row of its tile (on the warp boxes' borders at
    tiles 128 wide), as :func:`crafted_bins` makes them."""
    if knife and mxu:
        raise ValueError("knife-edge rows are edge-table rows: not with mxu")
    rng = np.random.default_rng(seed)
    nt = len(lengths)
    F = int(sum(lengths))
    tile = np.repeat(np.arange(nt), lengths)
    sx = (tile * tile_w)[:, None] + rng.uniform(-tile_w, 2 * tile_w, (F, 3))
    sy = rng.uniform(-tile_h, 2 * tile_h, (F, 3))
    sxy = torch.from_numpy(np.round(np.stack([sx, sy], -1) * 256.0)
                           / 256.0).float()
    z = torch.from_numpy(rng.uniform(-0.2, 1.2, (F, 3))).float()
    valid = torch.from_numpy(rng.random(F) >= nan_share)
    A, B, C, inv_area, sign, valid = raster3d.edge_coeffs(sxy, z, valid)
    attrs = torch.from_numpy(rng.uniform(0.0, 1.0, (F, 3, 4))).float()
    attrs[..., 2] += 0.5
    build = tile_raster.build_table_mxu if mxu else tile_raster.build_table
    table = build(A, B, C, z * inv_area[:, None], inv_area, sign, valid,
                  attrs)
    ids = (torch.from_numpy(tile).int() << raster3d.IDX_BITS) | torch.arange(
        F, dtype=torch.int32)
    spad = -(-F // 64) * 64 + 128
    pad = torch.full((spad - F,), (nt << raster3d.IDX_BITS) | F,
                     dtype=torch.int32)
    counts = torch.tensor(lengths, dtype=torch.int32)
    starts = (torch.cumsum(counts, 0) - counts).int()
    if knife:
        for t, n in enumerate(lengths):
            _knife(table, torch.arange(int(starts[t]), int(starts[t]) + n),
                   tile_w, tile_h, t, seed)
    counts[-1] += past_end
    return torch.cat([ids, pad]), starts, counts, table, nt * tile_w


def knife_edge_rows(tile_w: int, tile_h: int, ox: int, n: int, seed: int):
    """``n`` edge-table rows (``tile_raster.build_table``) of triangles on
    the edges of K5's cull, in a tile at (ox, 0): one edge of each runs
    through pixel coordinates on a border of a warp's box
    (``tile_raster.warp_boxes``, the whole tile at other widths than
    128: the first or last column of a box, a
    column just outside it, or the tile's first or last row), the third
    vertex 1..40 pixels to either side, so the edge's pixels are covered
    at 0 (e = 0) on one side of the border and not on the other; the
    edge coefficients are then scaled by a seeded choice of 1, 2^-60,
    2^60, 3.7e-20, 1e25 and 0.7 (the depth and attribute columns by its
    inverse), and a few rows get a NaN coefficient.  Depths in [0, 1]."""
    rng = np.random.default_rng(seed)
    layout = tile_raster.warp_boxes(tile_w, tile_h)
    boxes = (layout[0] if layout is not None else
             torch.tensor([[0, tile_w - 1, 0, tile_h - 1]]))
    sxy = np.zeros((n, 3, 2))
    for i in range(n):
        x0, x1, y0, y1 = boxes[rng.integers(len(boxes))].tolist()
        side = rng.choice([-1, 1])
        d = int(rng.integers(1, 41))
        if rng.random() < 0.6:    # a vertical edge on a box column
            c = ox + [x0, x1, x0 - 1, x1 + 1][rng.integers(4)]
            ya, yb = sorted(rng.integers(-6, tile_h + 6, 2).tolist())
            sxy[i] = [(c, ya), (c, yb + 1), (c + side * d,
                                             rng.integers(-4, tile_h + 4))]
        else:                     # a horizontal edge on a tile row
            r = [y0, y1, y0 - 1, y1 + 1][rng.integers(4)]
            xa, xb = sorted(rng.integers(ox - 6, ox + tile_w + 6,
                                         2).tolist())
            sxy[i] = [(xa, r), (xb + 1, r), (rng.integers(ox - 4,
                                                          ox + tile_w + 4),
                                             r + side * d)]
    sxy = torch.from_numpy(sxy).float()
    z = torch.from_numpy(rng.uniform(0.1, 0.9, (n, 3))).float()
    A, B, C, inv_area, sign, valid = raster3d.edge_coeffs(
        sxy, z, torch.ones(n, dtype=torch.bool))
    attrs = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3, 4))).float()
    rows = tile_raster.build_table(A, B, C, z * inv_area[:, None], inv_area,
                                   sign, valid, attrs)[:n]
    f = torch.from_numpy(rng.choice(
        np.array([1.0, 2.0 ** -60, 2.0 ** 60, 3.7e-20, 1e25, 0.7],
                 np.float32), n))[:, None]
    rows[:, 0:9] *= f
    rows[:, 9:12] /= f
    rows[:, 14:26] /= f
    nan = torch.from_numpy(rng.random(n) < 0.05)
    rows[nan, 3] = math.nan
    return rows


def crafted_bins(lengths, K: int, tile_w: int = 128, tile_h: int = 16,
                 seed: int = 0, knife: bool = True):
    """K5's inputs at the split walk's and the cull's edges: one row of
    ``len(lengths)`` tiles of tile_w x tile_h whose bins rows hold the
    seeded triangles of :func:`crafted_runs` (``lengths`` each, NaN rows
    among them), the first min(length, K) of each run and then the
    table's NaN pad row; counts are the full lengths, so a run longer
    than K overflows and walks its K slots.  With ``knife`` every third
    slot's triangle is replaced by a :func:`knife_edge_rows` row of its
    tile.  Returns (bins (NT, K) int32, counts (NT,) int32, table,
    width) on the CPU."""
    sp, st, ct, table, width = crafted_runs(lengths, tile_w, tile_h, seed)
    tri = sp & raster3d.IDX_MASK
    pad = table.shape[0] - 1
    bins = torch.full((len(lengths), K), pad, dtype=torch.int32)
    for t, n in enumerate(lengths):
        ids = tri[int(st[t]):int(st[t]) + min(n, K)]
        bins[t, :ids.numel()] = ids
        if knife:
            _knife(table, ids, tile_w, tile_h, t, seed)
    return bins, ct, table, width


def _knife(table, ids, tile_w: int, tile_h: int, t: int, seed: int):
    """Rows ids[1::3] of the table become :func:`knife_edge_rows` rows of
    tile t of a row of tiles (seed + 7 t)."""
    sel = ids[1::3].long()
    table[sel] = knife_edge_rows(tile_w, tile_h, t * tile_w, sel.numel(),
                                 seed + 7 * t)


def mma_probe_plain(rows, ox: int, oy: int, tile_w: int, mxu: int):
    """The plain version of the MMA walk's layout probe (the C entry
    ``tile_raster_mma_probe``, which ``chip_smoke.py`` runs on the card):
    one product of the walk's operands (``tile_raster.mma_operands``) for
    the n <= 16 affine rows ``rows`` (n, ROW_W) at the 64 pixels p of a
    tile at (ox, oy), ``tile_w`` wide (x = ox + p % tile_w, y = oy +
    p // tile_w), in float64 rounded to float32 and read back as the walk
    reads it: (64, 16, 4), [p, t, plane] the plane (e0, e1, e2, z) of
    triangle t at pixel p (t >= n: NaN)."""
    tile_raster._check_mxu(mxu)
    n = rows.shape[0]
    if rows.dim() != 2 or rows.shape[1] != tile_raster.ROW_W or \
            not 1 <= n <= 16:
        raise ValueError(f"rows must be (1..16, {tile_raster.ROW_W}), got "
                         f"{tuple(rows.shape)}")
    if tile_w < 1:
        raise ValueError(f"tile_w must be >= 1, got {tile_w}")
    p = torch.arange(64)
    A, B, cols = tile_raster.mma_operands(rows, (ox + p % tile_w).float(),
                                          (oy + p // tile_w).float(), mxu)
    out = torch.empty(64, 16, 4)
    out[:, cols[:, 0], cols[:, 1]] = (A.double() @ B.double()).float()
    return out
