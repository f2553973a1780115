"""Mesh -> frame paths of the z-buffered triangle rasterizer, in PyTorch.

Counterpart of ``libnativecpurenderer_tpu/ops/raster3d.py``: projection and
1/256 px snapping (``setup_triangles``), near-plane clipping
(``setup_triangles_clipped``), edge coefficients (``edge_coeffs``), tile
binning (``bin_triangles``, materialised bins; ``bin_triangles_flat``,
gatherless), the naive reference (``render_gouraud``), the fused binned
path (``raster_binned_fused``, ``render_gouraud_binned``,
``render_textured_binned``), the Gouraud entries ``render_gouraud_pallas``,
``render_gouraud_pallas_batch`` and ``render_gouraud_u8[_loop]``, the
textured ones ``render_textured_u8[_loop|_batch]`` (u8 texels) and
``render_textured`` (float texture, with depth), and the painter's-order
``render_blended``, with its binned form ``render_blended_u8_loop``
(BASELINE config 2: each frame's quads ordered back to front, binned by
draw step, blended in order by K7).  The per-tile visibility and shading
of the binned entries runs in ``tile_raster`` (the hand-written CUDA
kernels K1, K3, K2b, K2a, K5, K6 and K7, or their plain versions for CPU
tensors); the naive, fused and per-triangle blended paths are torch ops,
as they were XLA ops.

Every function runs on the device of the tensors it is given.  The op
order follows the JAX code op for op, and no step fuses a multiply into an
add: eager torch rounds each elementwise op, on the CPU and on the card
alike, so the CPU tests here and the card's run compute the same bits.
Visibility is the same packed-key minimum as in the JAX package:
``(quantised_z << IDX_BITS) | slot`` per covered pixel, lowest key wins
(the key format lives in ``tile_raster``, beside the row table).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import tile_raster
from .sampling import _to_i32
from .tile_raster import IDX_BITS, IDX_MASK, NO_TRI, SKY_KEY, Z_LEVELS

NEAR_EPS = 1e-6        # w <= NEAR_EPS is "behind the near plane"
SUBPIXEL = 256.0       # screen coords snap to 1/256 px
NAIVE_PAIRS = 1 << 22  # pixel-triangle pairs the naive path holds at once


def _snap(c):
    """Snap a screen coordinate to the 1/256 subpixel grid
    (``raster3d.py:47-59``).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    return torch.round(c * SUBPIXEL) / SUBPIXEL


def pregather_mesh(verts, faces):
    """Frame-invariant per-face gather of homogeneous vertex rows,
    (F, 3, 4) (``raster3d.py:62-73``).  Frame loops gather once and pass
    the result as ``v4f=`` / ``pre=``."""
    v4 = torch.cat([verts, verts.new_ones((verts.shape[0], 1))], -1)
    return v4[faces]


def _clip_rows(v4f, mvp):
    """``v4f @ mvp.T`` as a fixed-order 4-term sum of rounded products.

    A matmul would leave the order and width of the sum to the library:
    TF32 on the card moves vertices by far more than the 1/256 px snap,
    and a fused multiply-add changes the last bit.  Row r of the result
    is ((v0 m_r0 + v1 m_r1) + v2 m_r2) + v3 m_r3.  mvp (4, 4) gives
    (F, 3, 4); (B, 4, 4) gives (B, F, 3, 4), the same bits a frame."""
    m = mvp.to(dtype=v4f.dtype, device=v4f.device)[..., None, None, :, :]
    return (((v4f[..., 0:1] * m[..., 0] + v4f[..., 1:2] * m[..., 1])
             + v4f[..., 2:3] * m[..., 2]) + v4f[..., 3:4] * m[..., 3])


def setup_triangles(verts, faces, mvp, width: int, height: int, v4f=None):
    """Transform + project + snap (``raster3d.py:76-114``).

    verts: (V, 3) float; faces: (F, 3) int; mvp: (4, 4).  ``v4f``:
    optional (F, 3, 4) rows from :func:`pregather_mesh`.  Returns a dict
    of per-face tensors: sxy (F, 3, 2) snapped screen positions, z (F, 3)
    depth in [0, 1] for in-frustum vertices, valid (F,) bool (every
    vertex in front of w = 1e-6), inv_w (F, 3).  With mvp (B, 4, 4)
    every entry has a leading B."""
    if faces.shape[0] >= NO_TRI:
        raise ValueError(f"draw has {faces.shape[0]} faces; packed keys "
                         f"support < {NO_TRI}")
    if v4f is None:
        v4f = pregather_mesh(verts, faces)
    clipf = _clip_rows(v4f, mvp)            # (F, 3, 4)
    w = clipf[..., 3:4]
    w_ok = w[..., 0] > 1e-6
    wsafe = torch.where(w_ok[..., None], w, 1.0)
    ndc = clipf[..., :3] / wsafe
    fsx = _snap((ndc[..., 0] * 0.5 + 0.5) * width)
    fsy = _snap((0.5 - ndc[..., 1] * 0.5) * height)   # y down
    fz = ndc[..., 2] * 0.5 + 0.5
    valid = w_ok.all(dim=-1)
    sxy = torch.stack([fsx, fsy], dim=-1)
    inv_w = (1.0 / wsafe)[..., 0]
    return {"sxy": sxy, "z": fz, "valid": valid, "inv_w": inv_w}


def clip_near_triangles(clip, attrs, eps: float = NEAR_EPS):
    """Clip clip-space triangles against the near plane w = eps
    (``raster3d.py:117-178``).

    A triangle with 1 or 2 vertices behind the plane is cut into 1 or 2
    sub-triangles whose new vertices sit on the plane (positions and
    attributes interpolated with the same parameter t); a triangle wholly
    behind it becomes invalid.  Every input triangle owns two output
    slots, i and F + i.  clip (F, 3, 4), attrs (F, 3, D) -> (clip2
    (2F, 3, 4), attrs2 (2F, 3, D), valid (2F,) bool)."""
    dtype = clip.dtype
    i32 = torch.int32
    w = clip[..., 3]
    inside = w > eps
    n_in = inside.to(i32).sum(dim=1, dtype=i32)
    # rotate each triangle (keeping its winding) so that the one inside
    # vertex of n_in == 1 lands at 0 and the one outside vertex of
    # n_in == 2 at 2.  jnp.argmax of a bool is its first True; torch's
    # argmax also returns the first maximum, taken here of the ints
    out_idx = torch.argmax((~inside).to(i32), dim=1).to(i32)
    in_idx = torch.argmax(inside.to(i32), dim=1).to(i32)
    r = torch.where(n_in == 1, in_idx,
                    torch.where(n_in == 2, (out_idx + 1) % 3, 0))
    perm = ((r[:, None] + torch.arange(3, dtype=i32, device=clip.device))
            % 3).long()[..., None]
    vr = torch.gather(clip, 1, perm.expand(-1, -1, clip.shape[-1]))
    ar = torch.gather(attrs, 1, perm.expand(-1, -1, attrs.shape[-1]))
    v0, v1, v2 = vr[:, 0], vr[:, 1], vr[:, 2]
    a0, a1, a2 = ar[:, 0], ar[:, 1], ar[:, 2]
    w0, w1, w2 = vr[:, 0, 3], vr[:, 1, 3], vr[:, 2, 3]

    def isect(av, aa, bv, ba, wa, wb):
        denom = wb - wa
        t = ((eps - wa) / torch.where(denom == 0.0, 1.0, denom))[:, None]
        return av + t * (bv - av), aa + t * (ba - aa)

    i01v, i01a = isect(v0, a0, v1, a1, w0, w1)
    i02v, i02a = isect(v0, a0, v2, a2, w0, w2)
    i12v, i12a = isect(v1, a1, v2, a2, w1, w2)
    c3 = (n_in == 3)[:, None, None]
    c2 = (n_in == 2)[:, None, None]

    def pick(full, two, one):
        return torch.where(c3, full, torch.where(c2, two, one))

    # slot A: 3 in -> (v0, v1, v2); 2 in -> (v0, v1, i12); 1 in ->
    # (v0, i01, i02); slot B, only for the 2-in quad: (v0, i12, i02)
    tri_a_v = pick(torch.stack([v0, v1, v2], 1),
                   torch.stack([v0, v1, i12v], 1),
                   torch.stack([v0, i01v, i02v], 1))
    tri_a_a = pick(torch.stack([a0, a1, a2], 1),
                   torch.stack([a0, a1, i12a], 1),
                   torch.stack([a0, i01a, i02a], 1))
    tri_b_v = torch.stack([v0, i12v, i02v], 1)
    tri_b_a = torch.stack([a0, i12a, i02a], 1)
    clip2 = torch.cat([tri_a_v, tri_b_v]).to(dtype)
    attrs2 = torch.cat([tri_a_a, tri_b_a])
    valid = torch.cat([n_in >= 1, n_in == 2])
    return clip2, attrs2, valid


def setup_triangles_clipped(verts, faces, mvp, attrs, width: int,
                            height: int, eps: float = NEAR_EPS, v4f=None):
    """:func:`setup_triangles` with near-plane clipping
    (``raster3d.py:181-212``, see :func:`clip_near_triangles`).  attrs
    (F, 3, D) are clipped alongside the positions.  Returns (the per-face
    dict with 2F entries, clipped attrs (2F, 3, D))."""
    if 2 * faces.shape[0] >= NO_TRI:
        raise ValueError(f"clipped draw has {2 * faces.shape[0]} slots; "
                         f"packed keys support < {NO_TRI}")
    if v4f is None:
        v4f = pregather_mesh(verts, faces)
    clip2, attrs2, valid = clip_near_triangles(_clip_rows(v4f, mvp), attrs,
                                               eps)
    w = clip2[..., 3:4]
    # clipping pinned the new vertices to w ~= eps (up to an ulp), so the
    # per-vertex safety test is w > 0, not w > eps
    w_ok = w[..., 0] > 0.0
    valid = valid & w_ok.all(dim=1)
    wsafe = torch.where(w_ok[..., None], w, 1.0)
    ndc = clip2[..., :3] / wsafe
    fsx = _snap((ndc[..., 0] * 0.5 + 0.5) * width)
    fsy = _snap((0.5 - ndc[..., 1] * 0.5) * height)
    fz = ndc[..., 2] * 0.5 + 0.5
    sxy = torch.stack([fsx, fsy], dim=-1)
    inv_w = (1.0 / wsafe)[..., 0]
    return ({"sxy": sxy, "z": fz, "valid": valid, "inv_w": inv_w}, attrs2)


def edge_coeffs(sxy, z, valid, exact_c: bool = False):
    """Edge-function coefficients (``raster3d.py:215-237``).

    Edge i is opposite vertex i: e_i(x, y) = A_i x + B_i y + C_i equals
    the barycentric weight of vertex i times the signed doubled area.
    Returns (A, B, C) each (F, 3), inv_area (F,), sign (F,) and valid
    (F,) with degenerate triangles cleared; a leading B on the inputs
    gives one on each.

    With ``exact_c`` the constants ``x1 y2 - x2 y1`` are formed in
    float64, where the product of two float32 coordinates is exact, and
    rounded back to the coordinates' dtype.  In float32 the two rounded
    products cancel; that error put the u8 entries' frames further from
    the float64 oracle than JAX's, whose XLA:CPU program contracts the
    difference (``tests/test_torch_mesh_scale.py``).  The u8 entries take
    it; the float entries keep JAX's float32 expression, which their
    float contracts with JAX pin.  A float64 frame is the same either
    way."""
    x0, y0 = sxy[..., 0, 0], sxy[..., 0, 1]
    x1, y1 = sxy[..., 1, 0], sxy[..., 1, 1]
    x2, y2 = sxy[..., 2, 0], sxy[..., 2, 1]
    A = torch.stack([y1 - y2, y2 - y0, y0 - y1], -1)
    B = torch.stack([x2 - x1, x0 - x2, x1 - x0], -1)
    c = sxy.to(torch.float64) if exact_c else sxy
    cx0, cy0 = c[..., 0, 0], c[..., 0, 1]
    cx1, cy1 = c[..., 1, 0], c[..., 1, 1]
    cx2, cy2 = c[..., 2, 0], c[..., 2, 1]
    C = torch.stack([cx1 * cy2 - cx2 * cy1,
                     cx2 * cy0 - cx0 * cy2,
                     cx0 * cy1 - cx1 * cy0], -1).to(sxy.dtype)
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    nz = area2.abs() > 1e-12
    valid = valid & nz
    inv_area = torch.where(nz, 1.0 / torch.where(nz, area2, 1.0), 0.0)
    sign = torch.sign(area2)
    return A, B, C, inv_area, sign, valid


def _z_levels(dtype, dev):
    """Z_LEVELS as a device tensor: CUDA torch divides by a Python scalar
    as a multiply by its reciprocal."""
    return torch.full((), Z_LEVELS, dtype=dtype, device=dev)


def _pack_keys(e, z, sign, valid, tri_ids):
    """Coverage and packed (z << IDX_BITS | id) keys, SKY_KEY where not
    covered (``raster3d.py:240-251``); e (..., 3) edge values, z (...)
    interpolated depth, the rest broadcasting against z."""
    covered = (e * sign[..., None] >= 0.0).all(dim=-1) & valid
    covered = covered & (z >= 0.0) & (z <= 1.0)
    zq = torch.clamp(z * Z_LEVELS, 0, Z_LEVELS).to(torch.int32)
    return torch.where(covered, (zq << IDX_BITS) | tri_ids, SKY_KEY)


def visibility_naive(A, B, C, zplane, sign, valid, X, Y,
                     block: int = 16384):
    """The packed-key minimum over ALL triangles for every pixel
    (``raster3d.py:254-283``); X, Y (P,) pixel coordinates, zplane (F, 3)
    the vertex z scaled by inv_area.  Pixels go ``block`` at a time, as in
    JAX, and within a block the triangles go in chunks of at most
    NAIVE_PAIRS pixel-triangle pairs: the minimum is exact in any order,
    and one f32 block of 16384 pixels x 10k triangles would be ~2 GB.
    The depth is the explicit sum (e0 z0 + e1 z1) + e2 z2 (JAX's einsum
    leaves the order to the library)."""
    F = A.shape[0]
    dev = A.device
    tri_ids = torch.arange(F, dtype=torch.int32, device=dev)
    P = X.shape[0]
    keys = torch.full((P,), SKY_KEY, dtype=torch.int32, device=dev)
    for p0 in range(0, P, block):
        x = X[p0:p0 + block]
        y = Y[p0:p0 + block]
        fc = max(1, NAIVE_PAIRS // x.shape[0])
        for f0 in range(0, F, fc):
            f = slice(f0, f0 + fc)
            e = (A[f, :, None] * x + B[f, :, None] * y
                 + C[f, :, None])                        # (fc, 3, block)
            z = (e[:, 0] * zplane[f, 0, None] + e[:, 1] * zplane[f, 1, None]
                 + e[:, 2] * zplane[f, 2, None])         # (fc, block)
            k = _pack_keys(e.transpose(1, 2), z, sign[f, None],
                           valid[f, None], tri_ids[f, None])
            keys[p0:p0 + block] = torch.minimum(keys[p0:p0 + block],
                                                k.amin(dim=0))
    return keys


def shade(keys, A, B, C, inv_area, attrs, X, Y, bg):
    """The winner's attributes per pixel (``raster3d.py:286-305``): one
    row gather of [A B C inv_area attrs] per pixel, barycentric weights
    w = e * inv_area, out = (w0 a0 + w1 a1) + w2 a2; bg where no triangle
    covers.  attrs (F, 3, D); returns (P, D)."""
    D = attrs.shape[-1]
    F = A.shape[0]
    table = torch.cat([A, B, C, inv_area[:, None],
                       attrs.reshape(F, 3 * D)], dim=1)
    idx = keys & IDX_MASK
    hit = idx != NO_TRI
    row = table[torch.where(hit, idx, 0).long()]
    e = row[:, 0:3] * X[:, None] + row[:, 3:6] * Y[:, None] + row[:, 6:9]
    w = e * row[:, 9:10]
    out = (w[:, 0:1] * row[:, 10:10 + D]
           + w[:, 1:2] * row[:, 10 + D:10 + 2 * D]
           + w[:, 2:3] * row[:, 10 + 2 * D:10 + 3 * D])
    return torch.where(hit[:, None], out, bg[None, :])


def render_gouraud(verts, faces, vtx_colors, width: int, height: int,
                   mvp=None, bg=None, band_height: int = None,
                   full_height: int = None, y0=None):
    """Naive full-screen Gouraud render, every triangle against every
    pixel — counterpart of ``raster3d.render_gouraud``
    (``raster3d.py:308-339``), the correctness reference.  Returns (rgba
    (H, W, 4) in verts' dtype, bg where sky; zq (H, W) the quantised
    depth (key >> IDX_BITS) / Z_LEVELS, 1 for sky).

    For a band of rows of a taller frame (the JAX package's y-band
    sharding) pass ``band_height`` (rows rendered), ``full_height`` (the
    viewport height of the projection) and ``y0`` (the band's first
    row)."""
    dtype = verts.dtype
    dev = verts.device
    if mvp is None:
        mvp = torch.eye(4, dtype=dtype, device=dev)
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=dev)
    out_h = band_height if band_height is not None else height
    tri = setup_triangles(verts, faces, mvp, width,
                          full_height if full_height is not None else height)
    A, B, C, inv_area, sign, valid = edge_coeffs(tri["sxy"], tri["z"],
                                                 tri["valid"])
    zsc = tri["z"] * inv_area[:, None]
    X = torch.arange(width, dtype=dtype, device=dev).repeat(out_h)
    Y = torch.arange(out_h, dtype=dtype, device=dev).repeat_interleave(width)
    if y0 is not None:
        Y = Y + torch.as_tensor(y0, dtype=dtype, device=dev)
    keys = visibility_naive(A, B, C, zsc, sign, valid, X, Y)
    rgba = shade(keys, A, B, C, inv_area, vtx_colors[faces], X, Y,
                 torch.as_tensor(bg, dtype=dtype, device=dev))
    zq = (keys >> IDX_BITS).to(dtype) / _z_levels(dtype, dev)
    return rgba.reshape(out_h, width, 4), zq.reshape(out_h, width)


def _tile_box(sxy, valid, width: int, height: int, tile_w: int,
              tile_h: int, span_x: int, span_y: int):
    """Each triangle's tile AABB clamped to the grid, and the span
    overflow flag (what both binnings share, ``raster3d.py:360-377``):
    (x0c, y0c, x1c, y1c, nonempty, span_overflow); with a leading B on
    ``sxy`` and ``valid``, one on each and a flag a frame."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    dev = sxy.device
    xs = sxy[..., 0]
    ys = sxy[..., 1]
    # divisors as device tensors: CUDA torch divides by a Python scalar
    # as a multiply by its reciprocal, inexact for a tile size not a power
    # of 2 (torch.full fills on the device: no copy, no host sync)
    tw = torch.full((), float(tile_w), dtype=sxy.dtype, device=dev)
    th = torch.full((), float(tile_h), dtype=sxy.dtype, device=dev)
    x0c = _to_i32(torch.floor(xs.amin(dim=-1) / tw)).clamp(min=0)
    x1c = _to_i32(torch.floor(xs.amax(dim=-1) / tw)).clamp(max=ntx - 1)
    y0c = _to_i32(torch.floor(ys.amin(dim=-1) / th)).clamp(min=0)
    y1c = _to_i32(torch.floor(ys.amax(dim=-1) / th)).clamp(max=nty - 1)
    nonempty = valid & (x0c <= x1c) & (y0c <= y1c)
    span_overflow = (nonempty & ((x1c - x0c >= span_x)
                                 | (y1c - y0c >= span_y))).any(dim=-1)
    return x0c, y0c, x1c, y1c, nonempty, span_overflow


def _check_tiles(nt: int):
    if nt >= (1 << (31 - IDX_BITS)):
        raise ValueError(f"{nt} tiles is too many for packed binning")


def bin_triangles(sxy, valid, width: int, height: int, tile_w: int,
                  tile_h: int, capacity: int, span_x: int = 8,
                  span_y: int = 8):
    """Triangle ids bucketed per tile, materialised (``raster3d.py:346-408``).

    Each triangle emits one packed ``(tile << IDX_BITS) | tri`` pair per
    tile of its (span-capped) tile AABB, culled by the box only; one sort
    makes every tile's run contiguous, a left searchsorted of the tile ids
    finds each run, and a window of ``capacity`` slots from each run's
    start (reads clamped to the array) becomes the tile's bins row.
    Returns (bins (NT, capacity) int32, NO_TRI past the run; counts (NT,)
    int32, not clipped; overflow () bool: a box wider than the span window
    or a run longer than ``capacity``).

    B frames at once (a leading B on ``sxy`` and ``valid``) give
    (B, NT, capacity), (B, NT) and (B,), each frame's pairs sorted on
    their own row: each equal to that frame binned alone."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    nt = ntx * nty
    _check_tiles(nt)
    lead = tuple(sxy.shape[:-3])
    F = sxy.shape[-3]
    dev = sxy.device
    i32 = torch.int32
    x0c, y0c, x1c, y1c, nonempty, span_overflow = _tile_box(
        sxy, valid, width, height, tile_w, tile_h, span_x, span_y)
    txs = x0c[..., None] + torch.arange(span_x, dtype=i32, device=dev)
    tys = y0c[..., None] + torch.arange(span_y, dtype=i32, device=dev)
    ok = (nonempty[..., None, None]
          & (txs[..., None, :] <= x1c[..., None, None])
          & (tys[..., :, None] <= y1c[..., None, None]))  # (.., F, sy, sx)
    tid = torch.where(ok, tys[..., :, None] * ntx + txs[..., None, :], nt)
    tri = torch.arange(F, dtype=i32, device=dev)[:, None, None]
    packed = torch.sort(((tid << IDX_BITS) | tri).reshape(*lead, -1),
                        dim=-1).values
    tid_sorted = packed >> IDX_BITS
    tri_sorted = packed & IDX_MASK
    tiles = torch.arange(nt + 1, dtype=i32, device=dev)
    starts = torch.searchsorted(
        tid_sorted, tiles.expand(lead + (nt + 1,)).contiguous(),
        out_int32=True)
    counts = starts[..., 1:] - starts[..., :-1]
    slot = torch.arange(capacity, dtype=i32, device=dev)
    win = (starts[..., :-1, None] + slot).clamp(max=packed.shape[-1] - 1)
    ids = torch.gather(tri_sorted, -1, win.flatten(-2).long()).view_as(win)
    bins = torch.where(slot < counts[..., None], ids, NO_TRI)
    return bins, counts, span_overflow | (counts > capacity).any(dim=-1)


def bin_triangles_flat(sxy, valid, width: int, height: int, tile_w: int,
                       tile_h: int, block_k: int, span_x: int = 8,
                       span_y: int = 8, edges=None, ids=None,
                       tall_split: bool = True):
    """Gatherless tile binning (``raster3d.py:440-639``).

    Each valid triangle emits one packed ``(tile << IDX_BITS) | tri`` pair
    per tile of its (span-capped) tile AABB that its edges can reach
    (the edge-vs-tile cull, when ``edges=(A, B, C, sign)`` is given); one
    sort of the unique pairs makes every tile's run contiguous, and a
    left searchsorted of the tile ids finds each run.

    Returns (sorted_pad (Spad,) int32, starts (NT,) int32, counts (NT,)
    int32, overflow () bool).  Invalid emission slots carry the sentinel
    tile NT, and ``(NT << IDX_BITS) | F`` pads the array to a ``block_k``
    multiple plus two guard blocks, as in the JAX layout (tri F is the
    row table's NaN row).  ``overflow`` is raised by an AABB wider than
    the span window, by a run longer than ``block_k``, and by more tall
    triangles than the split's top-k budget holds.  The JAX entry's
    ``wide_split`` option (off by default there) is not ported: every
    piece emits the full ``span_x`` columns.

    B frames at once (a leading B on ``sxy``, ``valid`` and ``edges``)
    give (B, Spad), (B, NT), (B, NT) and (B,): each row sorted on its own,
    so a frame keeps its int32 keys, and equal to that frame binned alone
    in ``starts``, ``counts``, ``overflow`` and the pairs of tiles < NT.

    ``lax.top_k`` becomes ``torch.topk``; the two break ties in another
    order, which changes which sentinel slots the tail holds but no valid
    pair: an unchosen triangle with span <= SY_A emits no extra valid
    pair, and a chosen one beyond it raises the flag in both.

    ``ids`` ((F,) or (B, F) int32, each below F) puts triangle f's id in
    its pairs in place of f: the blend prep gives each triangle its draw
    step, so each tile's run comes out in draw order.  ``tall_split``
    False emits every triangle's whole span window instead of the tall
    split's top-k budget, which a batch with more tall triangles than
    the budget (the blend batch seen edge-on) would overflow."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    nt = ntx * nty
    _check_tiles(nt)
    lead = tuple(sxy.shape[:-3])
    F = sxy.shape[-3]
    dev = sxy.device
    i32 = torch.int32
    x0c, y0c, x1c, y1c, nonempty, span_overflow = _tile_box(
        sxy, valid, width, height, tile_w, tile_h, span_x, span_y)

    def emit(y0c_, x0c_, x1c_, y1c_, ne_, tri_ids, dy0: int, sy_n: int,
             edges_):
        """Packed pairs for tile rows y0c_+dy0 .. +sy_n-1 x columns
        x0c_ .. +span_x-1 of the given triangles, built (..., sy, sx, n)
        and flattened after the leading B."""
        dx = torch.arange(span_x, dtype=i32, device=dev)
        dyv = dy0 + torch.arange(sy_n, dtype=i32, device=dev)
        txs = x0c_[..., None, :] + dx[:, None]       # (..., sx, n)
        tys = y0c_[..., None, :] + dyv[:, None]      # (..., sy, n)
        ok = (ne_[..., None, None, :]
              & (txs[..., None, :, :] <= x1c_[..., None, None, :])
              & (tys[..., :, None, :] <= y1c_[..., None, None, :]))
        if edges_ is not None:
            # edge-vs-tile cull (raster3d.py:498-533): an edge's maximum
            # over the tile's pixel rectangle sits at the corner its
            # coefficient signs pick; the slack covers f32 rounding
            A, B, C, sign = edges_
            dtype = A.dtype
            fxl = (txs * tile_w).to(dtype)          # (..., sx, n)
            fyl = (tys * tile_h).to(dtype)          # (..., sy, n)
            fxh = fxl + (tile_w - 1)
            fyh = fyl + (tile_h - 1)
            cover = None
            for e in range(3):
                Ae = (A[..., e] * sign)[..., None, :]
                Be = (B[..., e] * sign)[..., None, :]
                Ce = (C[..., e] * sign)[..., None, None, :]
                ex = torch.maximum(Ae * fxh, Ae * fxl)      # (..., sx, n)
                ey = torch.maximum(Be * fyh, Be * fyl)      # (..., sy, n)
                emax = (ey[..., :, None, :] + ex[..., None, :, :] + Ce)
                slack = ((Ae.abs() * fxh)[..., None, :, :]
                         + (Be.abs() * fyh)[..., :, None, :]
                         + Ce.abs())
                keep = emax >= -1e-5 * slack
                cover = keep if cover is None else (cover & keep)
            ok = ok & cover
        tid = tys[..., :, None, :] * ntx + txs[..., None, :, :]
        tid = torch.where(ok, tid, nt)
        return ((tid << IDX_BITS)
                | tri_ids[..., None, None, :]).reshape(*lead, -1)

    # tall split (raster3d.py:539-615): a base box of SY_A rows for every
    # triangle, the remaining rows only for the top-TK tallest
    SY_A = 4
    all_tris = (torch.arange(F, dtype=i32, device=dev) if ids is None
                else ids)
    if tall_split and F >= 4096 and span_y > SY_A:
        TK = min(4096 if span_y >= 8 else 2048, F)
        pieces = [emit(y0c, x0c, x1c, y1c, nonempty, all_tris, 0, SY_A,
                       edges)]
        spans = torch.where(nonempty, y1c - y0c + 1, 0)
        tall_span, idx = torch.topk(spans, TK)
        span_overflow = span_overflow | (tall_span[..., -1] > SY_A)
        # each frame's rows of its own chosen triangles
        rows = ((torch.arange(lead[0], device=dev)[:, None], idx) if lead
                else (idx,))
        ed = (tuple(e[rows] for e in edges) if edges is not None else None)
        tall_ids = (idx.to(i32) if ids is None
                    else torch.gather(ids.expand(lead + (F,)), -1, idx))
        pieces.append(emit(y0c[rows], x0c[rows], x1c[rows], y1c[rows],
                           nonempty[rows], tall_ids, SY_A, span_y - SY_A,
                           ed))
    else:
        pieces = [emit(y0c, x0c, x1c, y1c, nonempty, all_tris, 0, span_y,
                       edges)]
    S = sum(p.shape[-1] for p in pieces)
    spad = (S // block_k + 3) * block_k
    pad_val = (nt << IDX_BITS) | F
    pieces.append(torch.full(lead + (spad - S,), pad_val, dtype=i32,
                             device=dev))
    sorted_pad = torch.sort(torch.cat(pieces, dim=-1), dim=-1).values
    tid_sorted = sorted_pad >> IDX_BITS
    tiles = torch.arange(nt + 1, dtype=i32, device=dev)
    starts = torch.searchsorted(
        tid_sorted, tiles.expand(lead + (nt + 1,)).contiguous(),
        out_int32=True)
    counts = starts[..., 1:] - starts[..., :-1]
    overflow = span_overflow | (counts > block_k).any(dim=-1)
    return sorted_pad, starts[..., :-1].contiguous(), counts, overflow


def clamp_mega(mega: int, tiles_per_frame: int) -> int:
    """Largest divisor of ``tiles_per_frame`` that is <= ``mega``, 0 when
    ``mega`` <= 0 (``raster3d.py:642-653``): how the entries clamp the
    tiles a program of the TPU's wf walk took, kept so that ``wf=n``
    walks what JAX's does (the persistent kernel itself takes any
    ``wf`` >= 1)."""
    if mega <= 0:
        return 0
    m = min(int(mega), int(tiles_per_frame))
    while tiles_per_frame % m:
        m -= 1
    return m


def viewport_mask(width: int, height: int, tile_w: int, tile_h: int):
    """(NT, P) bool CPU tensor, True where tile slot p lands inside the
    viewport (``raster3d.py:671-686``).  Slots past width/height of the
    ``tiled=True`` layout carry whatever the walk rasterised there."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    tids = np.arange(ntx * nty)
    px = np.arange(tile_h * tile_w) % tile_w
    py = np.arange(tile_h * tile_w) // tile_w
    x = (tids % ntx * tile_w)[:, None] + px[None, :]
    y = (tids // ntx * tile_h)[:, None] + py[None, :]
    return torch.from_numpy((x < width) & (y < height))


def detile_u8_host(tiles, width: int, height: int, tile_w: int,
                   tile_h: int):
    """NumPy detile of the ``tiled=True`` output (``raster3d.py:689-701``):
    (NT, P, 4) uint8 -> (H, W, 4) uint8, cropping padded slots.  Takes a
    numpy array or a tensor (copied to the host)."""
    if isinstance(tiles, torch.Tensor):
        tiles = tiles.cpu().numpy()
    tiles = np.asarray(tiles)
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    a = tiles.reshape(nty, ntx, tile_h, tile_w, 4)
    a = np.moveaxis(a, 2, 1).reshape(nty * tile_h, ntx * tile_w, 4)
    return np.ascontiguousarray(a[:height, :width])


def _setup_edges(verts, faces, mvp, width: int, height: int, *, v4f=None,
                 attrs=None, near_clip: bool = False, exact_c: bool = False):
    """Projection (with ``near_clip``, :func:`setup_triangles_clipped`,
    which clips the (F, 3, D) ``attrs`` alongside) and edge setup
    (``exact_c``: see :func:`edge_coeffs`): (tri, attrs, (A, B, C, zsc,
    inv_area, sign, valid)), zsc the vertex z scaled by inv_area."""
    if near_clip:
        tri, attrs = setup_triangles_clipped(verts, faces, mvp, attrs, width,
                                             height, v4f=v4f)
    else:
        tri = setup_triangles(verts, faces, mvp, width, height, v4f=v4f)
    A, B, C, inv_area, sign, valid = edge_coeffs(tri["sxy"], tri["z"],
                                                 tri["valid"], exact_c)
    return tri, attrs, (A, B, C, tri["z"] * inv_area[..., None], inv_area,
                        sign, valid)


def _prep_geometry(verts, faces, mvp, width: int, height: int, *,
                   tile_w: int, tile_h: int, capacity: int, span_x: int,
                   span_y: int, z_clip: bool, v4f=None, attrs=None,
                   near_clip: bool = False, exact_c: bool = False,
                   ids=None, tall_split: bool = True):
    """What the Gouraud and textured per-frame preps share: projection
    (near-clipped with ``near_clip``), edges and gatherless binning, with
    ``z_clip=False``'s check that every valid vertex z lies in [0, 1]
    (the condition under which skipping the per-pixel z test is sound,
    ``raster3d.py:917-925,1225-1233``) folded into the overflow flag;
    ``ids`` and ``tall_split`` as in :func:`bin_triangles_flat`.
    Returns (tri, attrs, (A, B, C, zsc, inv_area, sign, valid),
    {sorted_pad, starts, counts, overflow}); with mvp (B, 4, 4) each
    with a leading B, the check and the flag a frame."""
    with tracing.span("lncr.raster3d.edges"):
        tri, attrs, edges = _setup_edges(verts, faces, mvp, width, height,
                                         v4f=v4f, attrs=attrs,
                                         near_clip=near_clip,
                                         exact_c=exact_c)
    A, B, C, _, _, sign, valid = edges
    with tracing.span("lncr.raster3d.bin"):
        sorted_pad, starts, counts, overflow = bin_triangles_flat(
            tri["sxy"], valid, width, height, tile_w, tile_h, capacity,
            span_x, span_y, edges=(A, B, C, sign), ids=ids,
            tall_split=tall_split)
    if not z_clip:
        z = tri["z"]
        z_ok = torch.where(tri["valid"][..., None], (z >= 0.0) & (z <= 1.0),
                           True).flatten(-2).all(dim=-1)
        overflow = overflow | ~z_ok
    return tri, attrs, edges, {
        "sorted_pad": sorted_pad, "starts": starts, "counts": counts,
        "overflow": overflow}


def _frames_of(mvp, near_clip: bool) -> int:
    """Frames one prep covers: 1 for mvp (4, 4), B for (B, 4, 4), the
    batch's prep, which does not take ``near_clip`` (its clipping works
    on one frame's faces)."""
    if mvp.dim() == 2:
        return 1
    if mvp.dim() != 3:
        raise ValueError(f"mvp must be (4, 4) or (B, 4, 4), got "
                         f"{tuple(mvp.shape)}")
    if near_clip:
        raise ValueError("a batch of matrices (B, 4, 4) does not take "
                         "near_clip")
    return mvp.shape[0]


def prepare_frame(verts, faces, vtx_colors, width: int, height: int,
                  mvp=None, *, tile_w: int = 128, tile_h: int = 16,
                  capacity: int = 512, bg=None, span_x: int = 8,
                  span_y: int = 8, z_clip: bool = True, pre=None,
                  near_clip: bool = False, mxu: int = 0,
                  exact_c: bool = True):
    """Per-frame prep of :func:`render_gouraud_u8`, everything before the
    tile kernel (``raster3d.py:895-934``): returns a dict with the
    kernel's inputs ``sorted_pad``, ``starts``, ``counts``, ``table``,
    ``packed_bg`` and the device ``overflow`` flag, which with
    ``z_clip=False`` also carries the vertex-z check (see
    :func:`_prep_geometry`).  ``near_clip`` clips at the near plane (two
    table rows a face).  With ``mxu`` the table is the matrix-unit
    walk's affine one (``tile_raster.build_table_mxu``).  ``exact_c``
    (see :func:`edge_coeffs`) is the u8 entries' table; the float
    entries pass ``exact_c=False``.

    With mvp (B, 4, 4) one pass preps B frames: ``sorted_pad`` (B, Spad),
    ``starts`` and ``counts`` (B, NT), ``table`` (B, F + 1, ROW_W) and
    ``overflow`` (B,), each frame equal to its own prep (``sorted_pad``
    in its pairs of tiles < NT; see :func:`bin_triangles_flat`).  That
    pass takes ``mxu`` but not ``near_clip`` (``ValueError``).
    ``prepare_frame.calls`` and ``.frames`` count the calls and the
    frames they covered."""
    with tracing.span("lncr.raster3d.prep"):
        dtype = verts.dtype
        if mvp is None:
            mvp = torch.eye(4, dtype=dtype, device=verts.device)
        prepare_frame.calls += 1
        prepare_frame.frames += _frames_of(mvp, near_clip)
        if bg is None:
            bg = torch.zeros(4, dtype=dtype, device=verts.device)
        if pre is not None:
            v4f, attrs = pre
        else:
            v4f, attrs = None, vtx_colors[faces]
        _, attrs, edges, prep = _prep_geometry(
            verts, faces, mvp, width, height, tile_w=tile_w, tile_h=tile_h,
            capacity=capacity, span_x=span_x, span_y=span_y, z_clip=z_clip,
            v4f=v4f, attrs=attrs, near_clip=near_clip, exact_c=exact_c)
        with tracing.span("lncr.raster3d.table"):
            build = (tile_raster.build_table_mxu if mxu
                     else tile_raster.build_table)
            prep["table"] = build(*edges, attrs)
            prep["packed_bg"] = tile_raster.pack_bg(bg)
    return prep


prepare_frame.calls = 0
prepare_frame.frames = 0


def pack_texture_u8(tex_u8):
    """(th, tw, 4) uint8 texture -> (th * tw,) int32 packed texels,
    little-endian: r in the low byte (``raster3d.py:1200-1205``)."""
    if tex_u8.dtype != torch.uint8 or tex_u8.dim() != 3 \
            or tex_u8.shape[-1] != 4:
        raise ValueError(f"texture must be (th, tw, 4) uint8, got "
                         f"{tuple(tex_u8.shape)} {tex_u8.dtype}")
    return tex_u8.contiguous().view(torch.int32).reshape(-1)


def prepare_textured_frame(verts, faces, fuv, width: int, height: int,
                           mvp, *, tile_w: int, tile_h: int, capacity: int,
                           span_x: int, span_y: int,
                           perspective_correct: bool, z_clip: bool,
                           v4f=None, mxu: int = 0, exact_c: bool = True):
    """Per-frame prep of the textured entries, everything before the tile
    kernel — counterpart of ``_tex_prep`` (``raster3d.py:1208-1250``).
    ``fuv`` is ``uvs[faces]``, (F, 3, 2).  The row table carries the
    attributes [u/w, v/w, 1/w, 1], or [u, v, 1, 1] without
    ``perspective_correct``; with ``mxu`` it is the affine table of the
    matrix-unit walk (``tile_raster.build_table_mxu``); ``exact_c`` as in
    :func:`prepare_frame` (``render_textured`` passes False).  Returns a
    dict with
    ``sorted_pad``, ``starts``, ``counts``, ``table`` and the device
    ``overflow`` flag (with ``z_clip=False`` also the vertex-z check, see
    :func:`_prep_geometry`).  With mvp (B, 4, 4), B frames in one pass
    as in :func:`prepare_frame`; ``.calls`` and ``.frames`` count as
    there."""
    with tracing.span("lncr.raster3d.prep"):
        prepare_textured_frame.calls += 1
        prepare_textured_frame.frames += _frames_of(mvp, False)
        tri, _, edges, prep = _prep_geometry(
            verts, faces, mvp, width, height, tile_w=tile_w, tile_h=tile_h,
            capacity=capacity, span_x=span_x, span_y=span_y, z_clip=z_clip,
            v4f=v4f, exact_c=exact_c)
        with tracing.span("lncr.raster3d.table"):
            if perspective_correct:
                iw = tri["inv_w"][..., None]
                attrs = torch.cat([fuv * iw, iw, torch.ones_like(iw)],
                                  dim=-1)
            else:
                attrs = torch.cat([fuv, torch.ones_like(fuv)], dim=-1)
            build = (tile_raster.build_table_mxu if mxu
                     else tile_raster.build_table)
            prep["table"] = build(*edges, attrs)
    return prep


prepare_textured_frame.calls = 0
prepare_textured_frame.frames = 0


def _gouraud_u8(verts, faces, vtx_colors, width: int, height: int, mvp, *,
                tile_w: int, tile_h: int, capacity: int, bg, span_x: int,
                span_y: int, opaque: bool, z_clip: bool, tiled: bool,
                pre=None, near_clip: bool = False, wf: int = 0,
                mxu: int = 0):
    """The Gouraud u8 entries' body: :func:`prepare_frame`, one K1 launch
    (K1-wf with ``wf``, K1-mxu with ``mxu``) and the tiles or the detiled
    frame, for mvp (4, 4) or B frames' (B, 4, 4).  Returns (frames, the
    prep's overflow flag, a frame's or (B,))."""
    prep = prepare_frame(verts, faces, vtx_colors, width, height, mvp,
                         tile_w=tile_w, tile_h=tile_h, capacity=capacity,
                         bg=bg, span_x=span_x, span_y=span_y,
                         z_clip=z_clip, pre=pre, near_clip=near_clip,
                         mxu=mxu)
    args = (prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"], prep["packed_bg"], width, tile_w, tile_h)
    kw = dict(opaque=opaque, z_clip=z_clip)
    wf = clamp_mega(wf, prep["counts"].shape[-1])
    if wf:
        packed = tile_raster.raster_tiles_flat_u8_wf(*args, wf=wf, mxu=mxu,
                                                     **kw)
    elif mxu:
        packed = tile_raster.raster_tiles_flat_u8_mxu(*args, mxu=mxu, **kw)
    else:
        packed = tile_raster.raster_tiles_flat_u8(*args, **kw)
    if tiled:
        return tile_raster.tiles_u8(packed), prep["overflow"]
    return (tile_raster.detile_packed(packed, width, height, tile_w,
                                      tile_h), prep["overflow"])


def render_gouraud_u8(verts, faces, vtx_colors, width: int, height: int,
                      mvp=None, *, tile_w: int = 128, tile_h: int = 16,
                      capacity: int = 512, bg=None, span_x: int = 8,
                      span_y: int = 8, kcc: int = 32, opaque: bool = False,
                      z_clip: bool = True, pre=None, tiled: bool = False,
                      near_clip: bool = False, wf: int = 0, mxu: int = 0):
    """Binned Gouraud render to u8 — counterpart of
    ``render_gouraud_pallas(flat=True, u8=True, ...)``
    (``raster3d.py:844-952``).

    verts (V, 3), faces (F, 3), vtx_colors (V, 4), mvp (4, 4), bg (4,)
    are tensors on one device; the render runs there.  Returns
    ``(frame, overflow)``: frame (H, W, 4) uint8 — each channel
    clip(v * 255, 0, 255) truncated, bg quantised the same way where no
    triangle covers the pixel — or, with ``tiled=True``, the kernel's
    per-tile (NT, P, 4) layout (see :func:`detile_u8_host`,
    :func:`viewport_mask`); overflow is a device bool, True when the
    frame cannot be trusted (raise capacity/span_x/span_y, or keep
    z_clip on for geometry outside the depth range).

    ``capacity`` bounds a tile's run, ``span_x``/``span_y`` a triangle's
    tile AABB.  ``opaque=True`` writes alpha 255 without interpolating it
    (for meshes whose vertex alpha is 1).  ``z_clip=False`` drops the
    per-pixel 0 <= z <= 1 test (see :func:`prepare_frame`).  ``pre``:
    optional ``(pregather_mesh(verts, faces), vtx_colors[faces])`` hoisted
    out of frame loops.  ``near_clip`` cuts triangles crossing the near
    plane w = NEAR_EPS into sub-triangles (see
    :func:`clip_near_triangles`) instead of culling them whole.

    ``wf=n`` walks the tiles with K1-wf, K1's split walk whose blocks
    claim :func:`clamp_mega` (n, tiles) consecutive items of its plan at
    a time: the same frame as ``wf=0``.  ``mxu=1|2`` builds the affine
    table and walks it with the matrix-unit kernel K1-mxu (1: near
    float32, ±1 u8 slips against the default walk; 2: one bfloat16 pass,
    a measurement setting); with ``wf`` too, the claims take that walk.
    ``kcc`` is accepted for signature parity: it sized the TPU kernel's
    triangle chunk and changes no value.  The other TPU layout knobs of
    the JAX entry (``interpret``, ``resident_out``, ``mega``, ``out8``,
    ``ktail``, ``wide_split``) are not parameters."""
    return _gouraud_u8(verts, faces, vtx_colors, width, height, mvp,
                       tile_w=tile_w, tile_h=tile_h, capacity=capacity,
                       bg=bg, span_x=span_x, span_y=span_y, opaque=opaque,
                       z_clip=z_clip, tiled=tiled, pre=pre,
                       near_clip=near_clip, wf=wf, mxu=mxu)


def render_gouraud_u8_loop(verts, faces, vtx_colors, width: int,
                           height: int, mvps, *, tile_w: int = 32,
                           tile_h: int = 32, capacity: int = 1024, bg=None,
                           span_x: int = 5, span_y: int = 3, kcc: int = 32,
                           opaque: bool = True, z_clip: bool = False,
                           tiled: bool = False):
    """B frames of :func:`render_gouraud_u8` (mvps (B, 4, 4)) —
    counterpart of ``render_gouraud_pallas_loop``
    (``raster3d.py:1083-1136``), with its production defaults ((32, 32)
    tiles, span (5, 3), capacity 1024, opaque, z_clip off).  One prep
    pass over the B frames (:func:`prepare_frame` with the matrices),
    one K1 launch and one detile, each frame bit-equal to its own
    :func:`render_gouraud_u8`.  Returns (frames (B, H, W, 4) uint8 — or
    (B, NT, P, 4) when ``tiled`` — , overflow device bool over the
    batch).  No host sync: frames and flag stay on the device."""
    frames, overflow = _gouraud_u8(
        verts, faces, vtx_colors, width, height, mvps, tile_w=tile_w,
        tile_h=tile_h, capacity=capacity, bg=bg, span_x=span_x,
        span_y=span_y, opaque=opaque, z_clip=z_clip, tiled=tiled)
    return frames, overflow.any()


def _textured_u8(verts, faces, uvs, tex_u8, width: int, height: int, mvp,
                 *, tile_w: int, tile_h: int, capacity: int, bg,
                 span_x: int, span_y: int, perspective_correct: bool,
                 z_clip: bool, tiled: bool, pre=None, mxu: int = 0):
    """The textured u8 entries' body: :func:`prepare_textured_frame`, one
    K3 launch (K3's matrix-unit walk with ``mxu``) and the tiles or the
    detiled frame, for mvp (4, 4) (None: the identity) or B frames'
    (B, 4, 4).  Returns (frames, the prep's overflow flag, a frame's or
    (B,))."""
    dev = verts.device
    if mvp is None:
        mvp = torch.eye(4, dtype=verts.dtype, device=dev)
    if bg is None:
        bg = torch.zeros(4, dtype=torch.float32, device=dev)
    v4f, fuv, tex_packed = (pre if pre is not None else
                            (None, uvs[faces], pack_texture_u8(tex_u8)))
    prep = prepare_textured_frame(
        verts, faces, fuv, width, height, mvp, tile_w=tile_w, tile_h=tile_h,
        capacity=capacity, span_x=span_x, span_y=span_y,
        perspective_correct=perspective_correct, z_clip=z_clip, v4f=v4f,
        mxu=mxu)
    args = (prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"], tex_packed, tuple(tex_u8.shape[:2]),
            tile_raster.pack_bg(bg), width, tile_w, tile_h)
    if mxu:
        packed = tile_raster.raster_tiles_tex_u8_mxu(*args, z_clip=z_clip,
                                                     mxu=mxu)
    else:
        packed = tile_raster.raster_tiles_tex_u8(*args, z_clip=z_clip)
    if tiled:
        return tile_raster.tiles_u8(packed), prep["overflow"]
    return (tile_raster.detile_packed(packed, width, height, tile_w,
                                      tile_h), prep["overflow"])


def render_textured_u8(verts, faces, uvs, tex_u8, width: int, height: int,
                       mvp=None, *, tile_w: int = 32, tile_h: int = 32,
                       capacity: int = 1024, bg=None, span_x: int = 5,
                       span_y: int = 3, kcc: int = 32,
                       perspective_correct: bool = True,
                       z_clip: bool = True, pre=None, tiled: bool = False):
    """Binned textured render of one frame to u8 through K3, with the
    textured loop entry's production defaults (``raster3d.py:1432-1448``).

    verts (V, 3), faces (F, 3), uvs (V, 2), tex_u8 (th, tw, 4) uint8,
    mvp (4, 4), bg (4,) are tensors on one device; the render runs there.
    Each covered pixel takes the texel at the winner's clamped-nearest
    (u, v) — interpolated perspective-correct as [u/w, v/w, 1/w] unless
    ``perspective_correct=False`` — and each other pixel bg quantised as
    ``clip(v * 255, 0, 255)`` truncated.  Returns ``(frame, overflow)``:
    frame (H, W, 4) uint8, or with ``tiled=True`` the kernel's per-tile
    (NT, P, 4) layout (see :func:`detile_u8_host`); overflow a device
    bool, True when the frame cannot be trusted (see
    :func:`render_gouraud_u8`).  Tiles must hold P % 128 == 0 and
    P >= 256 pixels, as in the JAX entries.  ``pre``: optional
    ``(pregather_mesh(verts, faces), uvs[faces], pack_texture_u8(tex_u8))``
    hoisted out of frame loops.  ``kcc`` is accepted for signature
    parity and changes no value; the JAX entries' TPU knobs
    (``interpret``, ``tex_nw``, ``fb_tile_cap``, ``mxu``, ``tex_split``,
    ``mega``, ``tex_dyn``, ``out8``, ``ktail``, ``tex_when``,
    ``tex_skip``, ``fb_subrow``) are not parameters."""
    return _textured_u8(verts, faces, uvs, tex_u8, width, height, mvp,
                        tile_w=tile_w, tile_h=tile_h, capacity=capacity,
                        bg=bg, span_x=span_x, span_y=span_y,
                        perspective_correct=perspective_correct,
                        z_clip=z_clip, tiled=tiled, pre=pre)


def render_textured_u8_loop(verts, faces, uvs, tex_u8, width: int,
                            height: int, mvps, *, tile_w: int = 32,
                            tile_h: int = 32, capacity: int = 1024,
                            bg=None, span_x: int = 5, span_y: int = 3,
                            kcc: int = 32, perspective_correct: bool = True,
                            z_clip: bool = True, tiled: bool = False):
    """B frames of :func:`render_textured_u8` (mvps (B, 4, 4)) —
    counterpart of ``render_textured_pallas_loop``
    (``raster3d.py:1432-1517``) with its production defaults ((32, 32)
    tiles, span (5, 3), capacity 1024, perspective-correct, z_clip on).
    One prep pass over the B frames (:func:`prepare_textured_frame` with
    the matrices), one K3 launch and one detile, each frame bit-equal to
    its own :func:`render_textured_u8`.  Returns (frames (B, H, W, 4)
    uint8 — or (B, NT, P, 4) when ``tiled`` — , overflow device bool
    over the batch).  No host sync."""
    frames, overflow = _textured_u8(
        verts, faces, uvs, tex_u8, width, height, mvps, tile_w=tile_w,
        tile_h=tile_h, capacity=capacity, bg=bg, span_x=span_x,
        span_y=span_y, perspective_correct=perspective_correct,
        z_clip=z_clip, tiled=tiled)
    return frames, overflow.any()


def render_textured_u8_batch(verts, faces, uvs, tex_u8, width: int,
                             height: int, mvps, *, tile_w: int = 32,
                             tile_h: int = 32, capacity: int = 512,
                             bg=None, span_x: int = 5, span_y: int = 3,
                             kcc: int = 16, perspective_correct: bool = True,
                             z_clip: bool = True, tiled: bool = False,
                             mxu: int = 0):
    """B frames (mvps (B, 4, 4)) under the defaults of
    ``render_textured_pallas_batch`` (``raster3d.py:1344-1425``: capacity
    512, kcc 16): one prep pass over the B frames and one launch.  With
    ``mxu=0`` it is :func:`render_textured_u8_loop` under these defaults,
    an alias kept for the JAX entry's name (the JAX entry's vmapped prep
    was a TPU program layout).  With ``mxu=1|2`` the prep builds the
    affine table of the matrix-unit walk and the launch is K3's
    matrix-unit walk (``tile_raster.raster_tiles_tex_u8_mxu``): texels
    may flip to a neighbour at UV knife edges against the default walk.
    Returns (frames (B, H, W, 4) uint8 — or (B, NT, P, 4) when ``tiled``
    — , overflow device bool over the batch)."""
    frames, overflow = _textured_u8(
        verts, faces, uvs, tex_u8, width, height, mvps, tile_w=tile_w,
        tile_h=tile_h, capacity=capacity, bg=bg, span_x=span_x,
        span_y=span_y, perspective_correct=perspective_correct,
        z_clip=z_clip, tiled=tiled, mxu=mxu)
    return frames, overflow.any()


def render_textured(verts, faces, uvs, tex, width: int, height: int,
                    mvp=None, *, tile_w: int = 128, tile_h: int = 8,
                    capacity: int = 512, bg=None, span_x: int = 2,
                    span_y: int = 10, kcc: int = 16,
                    perspective_correct: bool = True):
    """Textured render of one frame through K2a — counterpart of
    ``render_textured_pallas`` (``raster3d.py:1141-1197``), with its
    defaults.  tex (th, tw, 4) is a float texture.  K2a interpolates the
    attributes and keeps the depth keys; then, per pixel, (u, v) is the
    winner's first two attributes, divided by the third only when
    ``perspective_correct``, and the clamped-nearest texel of ``tex`` is
    fetched.  Returns (rgba (H, W, 4) in verts' dtype, bg where no
    triangle covers the pixel; zq (H, W) the quantised depth
    (key >> IDX_BITS) / Z_LEVELS; overflow device bool)."""
    dtype = verts.dtype
    dev = verts.device
    if mvp is None:
        mvp = torch.eye(4, dtype=dtype, device=dev)
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=dev)
    prep = prepare_textured_frame(
        verts, faces, uvs[faces], width, height, mvp, tile_w=tile_w,
        tile_h=tile_h, capacity=capacity, span_x=span_x, span_y=span_y,
        perspective_correct=perspective_correct, z_clip=True, exact_c=False)
    keys, uvq = tile_raster.render_binned_pallas_flat(
        prep["sorted_pad"], prep["starts"], prep["counts"], prep["table"],
        torch.zeros(4, dtype=dtype, device=dev), width, height, tile_w,
        tile_h)
    hit = keys != SKY_KEY
    if perspective_correct:
        den = uvq[..., 2:3]
        uv = uvq[..., :2] / torch.where(den != 0.0, den, 1.0)
    else:
        uv = uvq[..., :2]
    th, tw = tex.shape[0], tex.shape[1]
    ui = _to_i32(uv[..., 0] * tw).clamp(0, tw - 1)
    vi = _to_i32(uv[..., 1] * th).clamp(0, th - 1)
    texel = tex.reshape(-1, 4)[(vi * tw + ui).long()]
    rgba = torch.where(hit[..., None], texel.to(dtype),
                       torch.as_tensor(bg, dtype=dtype, device=dev))
    zq = (keys >> IDX_BITS).to(dtype) / _z_levels(dtype, dev)
    return rgba, zq, prep["overflow"]


def raster_binned_fused(bins, A, B, C, zplane_scaled, inv_area, sign, valid,
                        attrs, bg, width: int, height: int, tile_w: int,
                        tile_h: int, batch_tiles: int = 128):
    """Per-tile visibility and shading over materialised bins as tensor
    ops — counterpart of ``raster3d.raster_binned_fused``
    (``raster3d.py:704-787``), the XLA path of the binned render.

    The row table [A B C zsc sign inv_area attrs*inv_area] stays in A's
    dtype (the kernels' ``build_table`` casts to float32), NaN rows for
    invalid triangles and the pad row F that NO_TRI slots read.  Per tile:
    the minimum packed key over its K bins (triangle ids, not slots), then
    each attribute as the sum over K of the winner's (e0 a0 + e1 a1) +
    e2 a2 and zeros: keys are unique within a tile, so the sum has one
    nonzero term and its order does not matter.  ``batch_tiles`` tiles go
    at a time (all with 0), which bounds only the temporaries' size
    (batch_tiles x K x P each).  attrs (F, 3, D); returns (keys (H, W)
    int32, rgba (H, W, D), bg where sky)."""
    ntx = (width + tile_w - 1) // tile_w
    nt, K = bins.shape
    dtype = A.dtype
    dev = A.device
    F = A.shape[0]
    D = attrs.shape[-1]
    P = tile_w * tile_h
    attrs_sc = attrs * inv_area[:, None, None]
    table = torch.cat([A, B, C, zplane_scaled, sign[:, None],
                       inv_area[:, None], attrs_sc.reshape(F, 3 * D)], dim=1)
    table = torch.where(valid[:, None], table, float("nan")).to(dtype)
    table = torch.cat([table, table.new_full((1, table.shape[1]),
                                             float("nan"))])
    safe = torch.where(bins == NO_TRI, F, bins)
    t = torch.arange(nt, dtype=torch.int32, device=dev)
    p = torch.arange(P, dtype=torch.int32, device=dev)
    X = (t % ntx * tile_w).to(dtype)[:, None] + (p % tile_w).to(dtype)
    Y = (t // ntx * tile_h).to(dtype)[:, None] + (p // tile_w).to(dtype)
    bgv = torch.as_tensor(bg, dtype=dtype, device=dev)
    keys = torch.empty((nt, P), dtype=torch.int32, device=dev)
    rgba = torch.empty((nt, P, D), dtype=dtype, device=dev)
    step = batch_tiles if 0 < batch_tiles < nt else nt
    for t0 in range(0, nt, step):
        tiles = slice(t0, t0 + step)
        ids = safe[tiles]
        r = table[ids.long()][..., None]                 # (bt, K, cols, 1)
        x, y = X[tiles, None, :], Y[tiles, None, :]      # (bt, 1, P)
        e0 = r[:, :, 0] * x + r[:, :, 3] * y + r[:, :, 6]   # (bt, K, P)
        e1 = r[:, :, 1] * x + r[:, :, 4] * y + r[:, :, 7]
        e2 = r[:, :, 2] * x + r[:, :, 5] * y + r[:, :, 8]
        sg = r[:, :, 12]
        m = torch.minimum(torch.minimum(e0 * sg, e1 * sg), e2 * sg)
        zz = e0 * r[:, :, 9] + e1 * r[:, :, 10] + e2 * r[:, :, 11]
        covered = (m >= 0.0) & (zz >= 0.0) & (zz <= 1.0)
        zq = torch.clamp(zz * Z_LEVELS, 0, Z_LEVELS).to(torch.int32)
        k = torch.where(covered, (zq << IDX_BITS) | ids[:, :, None], SKY_KEY)
        winner = k.amin(dim=1)                           # (bt, P)
        win = (k == winner[:, None, :]) & covered
        for d in range(D):
            cd = (e0 * r[:, :, 14 + d] + e1 * r[:, :, 14 + D + d]
                  + e2 * r[:, :, 14 + 2 * D + d])
            acc = torch.where(win, cd, 0.0).sum(dim=1)
            rgba[tiles, :, d] = torch.where(winner != SKY_KEY, acc, bgv[d])
        keys[tiles] = winner
    return (tile_raster._detile_plane(keys, width, height, tile_w, tile_h),
            tile_raster._detile_plane(rgba, width, height, tile_w, tile_h))


def render_gouraud_binned(verts, faces, vtx_colors, width: int, height: int,
                          mvp=None, *, tile_w: int = 128, tile_h: int = 16,
                          capacity: int = 64, bg=None, span_x: int = 8,
                          span_y: int = 8, batch_tiles: int = 128,
                          perspective_correct: bool = False,
                          near_clip: bool = False):
    """Binned Gouraud render through :func:`bin_triangles` and
    :func:`raster_binned_fused` — counterpart of
    ``raster3d.render_gouraud_binned`` (``raster3d.py:790-837``).
    ``perspective_correct`` interpolates the attributes hyperbolically
    (attr/w and 1/w planes, divided per pixel); ``near_clip`` cuts
    triangles crossing the near plane instead of culling them.  Returns
    (rgba (H, W, 4) in verts' dtype, bg where sky; zq (H, W); overflow
    device bool)."""
    dtype = verts.dtype
    dev = verts.device
    if mvp is None:
        mvp = torch.eye(4, dtype=dtype, device=dev)
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=dev)
    tri, attrs, edges = _setup_edges(verts, faces, mvp, width, height,
                                     attrs=vtx_colors[faces],
                                     near_clip=near_clip)
    bins, counts, overflow = bin_triangles(tri["sxy"], edges[-1], width,
                                           height, tile_w, tile_h, capacity,
                                           span_x, span_y)
    bg_eff = torch.as_tensor(bg, dtype=dtype, device=dev)
    if perspective_correct:
        iw = tri["inv_w"][..., None]
        attrs = torch.cat([attrs * iw, iw], dim=-1)       # (F, 3, D + 1)
        bg_eff = torch.cat([bg_eff, bg_eff.new_ones(1)])
    keys, rgba = raster_binned_fused(bins, *edges, attrs, bg_eff, width,
                                     height, tile_w, tile_h, batch_tiles)
    if perspective_correct:
        den = rgba[..., -1:]
        rgba = torch.where((keys != SKY_KEY)[..., None],
                           rgba[..., :-1] / torch.where(den != 0.0, den, 1.0),
                           rgba[..., :-1])
    zq = (keys >> IDX_BITS).to(dtype) / _z_levels(dtype, dev)
    return rgba, zq, overflow


def render_gouraud_pallas(verts, faces, vtx_colors, width: int, height: int,
                          mvp=None, *, tile_w: int = 128, tile_h: int = 16,
                          capacity: int = 512, bg=None, span_x: int = 8,
                          span_y: int = 8, kcc: int = 32, flat: bool = False,
                          near_clip: bool = False, u8: bool = False,
                          opaque: bool = False, z_clip: bool = True,
                          pre=None, tiled: bool = False, wf: int = 0,
                          mxu: int = 0):
    """Binned Gouraud render through the tile kernels — counterpart of
    ``raster3d.render_gouraud_pallas`` (``raster3d.py:844-966``), with its
    defaults.  Routes:
      * default: :func:`bin_triangles` (box-culled, ``capacity`` bins a
        tile) and one K5 launch (``tile_raster.render_binned_pallas``);
        rgba in verts' dtype;
      * ``flat=True``: the gatherless binning (``capacity`` bounds a run)
        and one K2a launch (``render_binned_pallas_flat``); rgba float32;
      * ``flat=True, u8=True``: :func:`render_gouraud_u8` (K1), returning
        (frame (H, W, 4) uint8 — or with ``tiled`` the (NT, P, 4) tiles —,
        None, overflow), with ``opaque``, ``z_clip``, ``wf`` (K1-wf) and
        ``mxu`` (K1-mxu); the other routes refuse ``wf`` and ``mxu``
        with a ValueError, as the JAX entry asserts.
    Otherwise returns (rgba (H, W, 4), bg where sky; zq (H, W) the
    quantised depth (key >> IDX_BITS) / Z_LEVELS; overflow device bool).
    ``z_clip=False`` skips the per-pixel z test only on the u8 route (the
    f32 kernels keep it), and folds the vertex-z check into the flat
    routes' flag.  ``near_clip`` and ``pre`` = ``(pregather_mesh(verts,
    faces), vtx_colors[faces])`` apply on every route.  ``kcc`` is
    accepted and changes no value; the other TPU layout knobs
    (``interpret``, ``resident_out``, ``mega``, ``out8``, ``ktail``,
    ``wide_split``) are not parameters."""
    if u8 and not flat:
        raise ValueError("u8 output requires flat=True")
    if tiled and not u8:
        raise ValueError("tiled output is wired for the u8 path")
    if mxu and not u8:
        raise ValueError("mxu walk requires flat=True, u8=True")
    if wf and not u8:
        raise ValueError("the wf loop is wired for the u8 video path "
                         "(flat=True, u8=True)")
    if u8:
        frame, overflow = render_gouraud_u8(
            verts, faces, vtx_colors, width, height, mvp, tile_w=tile_w,
            tile_h=tile_h, capacity=capacity, bg=bg, span_x=span_x,
            span_y=span_y, opaque=opaque, z_clip=z_clip, pre=pre,
            tiled=tiled, near_clip=near_clip, wf=wf, mxu=mxu)
        return frame, None, overflow
    dtype = verts.dtype
    dev = verts.device
    if mvp is None:
        mvp = torch.eye(4, dtype=dtype, device=dev)
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=dev)
    if flat:
        prep = prepare_frame(verts, faces, vtx_colors, width, height, mvp,
                             tile_w=tile_w, tile_h=tile_h, capacity=capacity,
                             bg=bg, span_x=span_x, span_y=span_y,
                             z_clip=z_clip, pre=pre, near_clip=near_clip,
                             exact_c=False)
        keys, rgba = tile_raster.render_binned_pallas_flat(
            prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"], bg, width, height, tile_w, tile_h)
        overflow = prep["overflow"]
    else:
        v4f, attrs = pre if pre is not None else (None, vtx_colors[faces])
        tri, attrs, edges = _setup_edges(verts, faces, mvp, width, height,
                                         v4f=v4f, attrs=attrs,
                                         near_clip=near_clip)
        bins, counts, overflow = bin_triangles(
            tri["sxy"], edges[-1], width, height, tile_w, tile_h, capacity,
            span_x, span_y)
        keys, rgba = tile_raster.render_binned_pallas(
            bins, counts, *edges, attrs, bg, width, height, tile_w, tile_h)
    zq = (keys >> IDX_BITS).to(dtype) / _z_levels(dtype, dev)
    return rgba, zq, overflow


def render_gouraud_pallas_batch(verts, faces, vtx_colors, width: int,
                                height: int, mvps, *, tile_w: int = 128,
                                tile_h: int = 32, capacity: int = 512,
                                bg=None, span_x: int = 8, span_y: int = 4,
                                flat: bool = False, kcc: int = 32,
                                u8: bool = False, opaque: bool = False,
                                z_clip: bool = True, dynrows: int = 0,
                                rows_cap: int = 0, mxu: int = 0):
    """B frames (mvps (B, 4, 4)) of :func:`render_gouraud_pallas`, the
    tiles of all frames in one kernel launch — counterpart of
    ``raster3d.render_gouraud_pallas_batch`` (``raster3d.py:973-1076``),
    with its defaults.  One prep pass over the B frames, then:
      * default: K5 over the B frames' bins (``render_binned_pallas_batch``);
      * ``flat=True``: K2a (``render_binned_pallas_flat_batch``);
      * ``flat=True, u8=True``: K1
        (``render_binned_pallas_flat_batch_u8``), with ``opaque``,
        ``z_clip``; with ``mxu=1|2`` the tables are the affine ones and
        the launch is K1-mxu's (not with ``dynrows``);
      * ``dynrows=g`` (flat, u8, opaque, z_clip off): each frame's table
        rows gathered in pair order, ``rows_cap`` rows a frame (default
        49152), and K6 (``render_binned_dynrows_batch_u8``), bit-equal to
        the u8 route; a frame whose pairs end past rows_cap - capacity
        raises the overflow flag.  g, the TPU kernel's frames a program,
        changes no value.
    Returns (rgba (B, H, W, 4) — float32, or uint8 on the u8 routes —,
    zq (B, H, W) or None on the u8 routes, overflow device bool over the
    batch).  ``kcc`` is accepted and changes no value; ``interpret`` and
    ``wf`` (JAX's batch entry has none) are not parameters."""
    if u8 and not flat:
        raise ValueError("u8 output requires flat=True")
    if mxu and not (flat and u8 and not dynrows):
        raise ValueError("mxu walk requires flat=True, u8=True and no "
                         "dynrows")
    if dynrows and not (flat and u8 and opaque and not z_clip):
        raise ValueError("the dynrows kernel is the opaque u8 path: flat, "
                         "u8, opaque, z_clip=False")
    dtype = verts.dtype
    dev = verts.device
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=dev)
    cfg = dict(tile_w=tile_w, tile_h=tile_h, capacity=capacity,
               span_x=span_x, span_y=span_y)
    if flat:
        prep = prepare_frame(verts, faces, vtx_colors, width, height, mvps,
                             bg=bg, z_clip=z_clip, mxu=mxu, exact_c=u8,
                             **cfg)
        sps, starts, counts, tables = (prep[k] for k in (
            "sorted_pad", "starts", "counts", "table"))
        overflow = prep["overflow"].any()
        if dynrows:
            cap = rows_cap or 49152
            ids = (sps[:, :cap] & IDX_MASK).long()
            rows = torch.gather(tables, 1, ids[..., None].expand(
                -1, -1, tables.shape[-1]))
            # the pairs end at the last tile's run end
            overflow = overflow | (starts[:, -1] + counts[:, -1]
                                   > cap - capacity).any()
            frames = tile_raster.render_binned_dynrows_batch_u8(
                rows, starts, counts, bg, width, height, tile_w, tile_h,
                g=dynrows)
            return frames, None, overflow
        if u8:
            frames = tile_raster.render_binned_pallas_flat_batch_u8(
                sps, starts, counts, tables, bg, width, height, tile_w,
                tile_h, opaque=opaque, z_clip=z_clip, mxu=mxu)
            return frames, None, overflow
        keys, rgba = tile_raster.render_binned_pallas_flat_batch(
            sps, starts, counts, tables, bg, width, height, tile_w, tile_h)
    else:
        tri, attrs, edges = _setup_edges(verts, faces, mvps, width, height,
                                         attrs=vtx_colors[faces])
        bins, counts, overflow = bin_triangles(
            tri["sxy"], edges[-1], width, height, tile_w, tile_h, capacity,
            span_x, span_y)
        keys, rgba = tile_raster.render_binned_pallas_batch(
            torch.where(bins == NO_TRI, faces.shape[0], bins), counts,
            tile_raster.build_table(*edges, attrs), bg, width, height,
            tile_w, tile_h)
        overflow = overflow.any()
    zq = (keys >> IDX_BITS).to(dtype) / _z_levels(dtype, dev)
    return rgba, zq, overflow


def render_textured_binned(verts, faces, uvs, tex, width: int, height: int,
                           mvp=None, *, tile_w: int = 128, tile_h: int = 16,
                           capacity: int = 64, bg=None, span_x: int = 8,
                           span_y: int = 8, batch_tiles: int = 128,
                           perspective_correct: bool = True):
    """Binned textured render through :func:`raster_binned_fused` —
    counterpart of ``raster3d.render_textured_binned``
    (``raster3d.py:1522-1568``): the (u, v) ride the fused pass as
    attributes ([u/w, v/w, 1/w] when ``perspective_correct``, divided per
    pixel), then each covered pixel takes the clamped-nearest texel of
    ``tex`` (th, tw, 4).  Returns (rgba (H, W, 4), bg where sky; zq
    (H, W); overflow device bool)."""
    dtype = verts.dtype
    dev = verts.device
    if mvp is None:
        mvp = torch.eye(4, dtype=dtype, device=dev)
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=dev)
    tri, attrs, edges = _setup_edges(verts, faces, mvp, width, height,
                                     attrs=uvs[faces])
    bins, counts, overflow = bin_triangles(tri["sxy"], edges[-1], width,
                                           height, tile_w, tile_h, capacity,
                                           span_x, span_y)
    if perspective_correct:
        iw = tri["inv_w"][..., None]
        attrs = torch.cat([attrs * iw, iw], dim=-1)       # (F, 3, 3)
    keys, uvq = raster_binned_fused(
        bins, *edges, attrs, torch.zeros(attrs.shape[-1], dtype=dtype,
                                         device=dev),
        width, height, tile_w, tile_h, batch_tiles)
    hit = keys != SKY_KEY
    if perspective_correct:
        den = uvq[..., 2:3]
        uvq = uvq[..., :2] / torch.where(den != 0.0, den, 1.0)
    th, tw = tex.shape[0], tex.shape[1]
    ui = _to_i32(uvq[..., 0] * tw).clamp(0, tw - 1)
    vi = _to_i32(uvq[..., 1] * th).clamp(0, th - 1)
    texel = tex.reshape(-1, 4)[(vi * tw + ui).long()]
    rgba = torch.where(hit[..., None], texel,
                       torch.as_tensor(bg, dtype=tex.dtype, device=dev))
    zq = (keys >> IDX_BITS).to(dtype) / _z_levels(dtype, dev)
    return rgba, zq, overflow


def render_blended(verts, faces, uvs, tex, width: int, height: int,
                   mvp=None, opaque_depth=None, bg=None):
    """Painter's-order alpha blending with a z test against an opaque
    depth — counterpart of ``raster3d.render_blended``
    (``raster3d.py:1575-1623``), BASELINE config 2.  Triangles are drawn
    in face order (callers sort them back to front); each samples ``tex``
    (th, tw, 4) at its barycentric (u, v), nearest, and blends src-over
    where it covers the pixel and 0 <= z <= opaque_depth (default 1).
    One pass a triangle, for quad batches, not meshes.  The barycentric
    sums of z, u and v are (w0 q0 + w1 q1) + w2 q2 (JAX's einsum leaves
    their order to the library).  Returns the (H, W, 4) frame in verts'
    dtype."""
    dtype = verts.dtype
    dev = verts.device
    H, W = height, width
    if mvp is None:
        mvp = torch.eye(4, dtype=dtype, device=dev)
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=dev)
    tri = setup_triangles(verts, faces, mvp, width, height)
    A, B, C, inv_area, sign, valid = edge_coeffs(tri["sxy"], tri["z"],
                                                 tri["valid"])
    if opaque_depth is None:
        opaque_depth = torch.ones((H, W), dtype=dtype, device=dev)
    fuv = uvs[faces]                                      # (F, 3, 2)
    X = torch.arange(W, dtype=dtype, device=dev).expand(H, W)
    Y = torch.arange(H, dtype=dtype, device=dev)[:, None].expand(H, W)
    fb = torch.as_tensor(bg, device=dev).to(dtype).expand(H, W, 4)
    th, tw = tex.shape[0], tex.shape[1]
    tex_flat = tex.reshape(-1, 4)

    def bary(wgt, q):
        return wgt[0] * q[0] + wgt[1] * q[1] + wgt[2] * q[2]

    for i in range(faces.shape[0]):
        e = (A[i, :, None, None] * X + B[i, :, None, None] * Y
             + C[i, :, None, None])                       # (3, H, W)
        wgt = e * inv_area[i]
        z = bary(wgt, tri["z"][i])
        covered = (e * sign[i] >= 0.0).all(dim=0) & valid[i]
        covered = covered & (z >= 0.0) & (z <= opaque_depth)
        u = bary(wgt, fuv[i, :, 0])
        v = bary(wgt, fuv[i, :, 1])
        ui = _to_i32(u * tw).clamp(0, tw - 1)
        vi = _to_i32(v * th).clamp(0, th - 1)
        texel = tex_flat[(vi * tw + ui).long()]           # (H, W, 4)
        alpha = texel[..., 3:4]
        blended = fb[..., :3] * (1 - alpha) + texel[..., :3] * alpha
        new = torch.cat([blended, torch.maximum(fb[..., 3:], alpha)], -1)
        fb = torch.where(covered[..., None], new, fb)
    return fb


def quad_centres(verts, faces):
    """(Q, 3) float64 centres of the quads of a blend batch: faces 2q and
    2q + 1 are quad q split along its diagonal, (a, b, c) and (a, c, d),
    as ``models.mesh.quad_batch`` lays them out, and its centre is
    ((a + b) + (c + d)) / 4 of the float vertices, in float64.  Raises
    ``ValueError`` for faces that are not such pairs."""
    if faces.dim() != 2 or faces.shape[0] % 2 or faces.shape[1] != 3:
        raise ValueError(f"a blend batch draws quads, two faces each: got "
                         f"faces {tuple(faces.shape)}")
    f = faces.reshape(-1, 2, 3)
    if not bool(((f[:, 1, 0] == f[:, 0, 0]) & (f[:, 1, 1] == f[:, 0, 2]))
                .all()):
        raise ValueError("faces 2q and 2q + 1 must be (a, b, c) and "
                         "(a, c, d), one quad split along its diagonal")
    v = verts.to(torch.float64)[torch.stack(
        [f[:, 0, 0], f[:, 0, 1], f[:, 0, 2], f[:, 1, 2]], dim=1)]
    return ((v[:, 0] + v[:, 1]) + (v[:, 2] + v[:, 3])) * 0.25


def blend_order(centres, mvp):
    """The draw order of a blend batch: quads back to front by the
    clip-space w of their centre, ((m30 x + m31 y) + m32 z) + m33 in
    float64 from the float32 matrix (mvp (4, 4), or (B, 4, 4) for B
    frames), ties by quad index; each quad's two faces drawn together,
    2q then 2q + 1.  float32 keys would not do: about 20 pairs of the
    4,096 quads of BASELINE config 2 lie closer in w than float32
    resolves.  Returns (draw, step): draw (..., F) int32, the face drawn
    at each step, and step (..., F) int32, each face's step.
    ``blend_order.quads`` counts the quads ordered."""
    m = mvp.to(torch.float64)
    c = centres.to(device=m.device)
    w = (((m[..., 3, 0, None] * c[:, 0] + m[..., 3, 1, None] * c[:, 1])
          + m[..., 3, 2, None] * c[:, 2]) + m[..., 3, 3, None])
    order = torch.sort(-w, dim=-1, stable=True).indices     # (..., Q)
    blend_order.quads += order.numel()
    draw = (2 * order[..., None]
            + torch.arange(2, device=m.device)).flatten(-2)
    step = torch.empty_like(draw).scatter_(
        -1, draw, torch.arange(draw.shape[-1], device=m.device).expand_as(
            draw).contiguous())
    return draw.to(torch.int32), step.to(torch.int32)


blend_order.quads = 0


def blend_pre(verts, faces, uvs, tex_u8):
    """What :func:`render_blended_u8_loop` hoists out of a frame loop:
    ``(pregather_mesh(verts, faces), uvs[faces],
    pack_texture_u8(tex_u8), quad_centres(verts, faces))``."""
    return (pregather_mesh(verts, faces), uvs[faces],
            pack_texture_u8(tex_u8), quad_centres(verts, faces))


def prepare_blended_frame(verts, faces, fuv, width: int, height: int, mvp,
                          *, centres, tile_w: int, tile_h: int,
                          capacity: int, span_x: int, span_y: int,
                          v4f=None):
    """The blend prep, everything before K7, for mvp (4, 4) or B frames'
    (B, 4, 4) in one pass: the draw order of each frame
    (:func:`blend_order` of the quads' ``centres``), projection, edges
    (the u8 entries' constants, see :func:`edge_coeffs`), the gatherless
    binning
    with each triangle's draw step as its id (so each tile's run lists
    its triangles back to front, with no gather of faces) and no tall
    split (more than its 4,096 triangles are tall when quads turn
    edge-on), and the blend
    table (``tile_raster.build_blend_table``: edges, vertex z and
    (u, v); ``fuv`` is ``uvs[faces]``).  Returns a dict with
    ``sorted_pad``, ``starts``, ``counts``, ``table``, ``order`` (the
    face drawn at each step) and the device ``overflow`` flag, each with
    a leading B for B frames.  ``prepare_blended_frame.calls`` and
    ``.frames`` count the calls and the frames they covered."""
    with tracing.span("lncr.raster3d.prep"):
        prepare_blended_frame.calls += 1
        prepare_blended_frame.frames += _frames_of(mvp, False)
        with tracing.span("lncr.raster3d.blend_order"):
            draw, step = blend_order(centres, mvp)
        tri, _, edges, prep = _prep_geometry(
            verts, faces, mvp, width, height, tile_w=tile_w, tile_h=tile_h,
            capacity=capacity, span_x=span_x, span_y=span_y, z_clip=True,
            v4f=v4f, exact_c=True, ids=step, tall_split=False)
        A, B, C, _, inv_area, sign, valid = edges
        with tracing.span("lncr.raster3d.table"):
            prep["table"] = tile_raster.build_blend_table(
                A, B, C, tri["z"], inv_area, sign, valid, fuv)
        prep["order"] = draw
    return prep


prepare_blended_frame.calls = 0
prepare_blended_frame.frames = 0


def render_blended_u8_loop(verts, faces, uvs, tex_u8, width: int,
                           height: int, mvps, *, opaque_depth=None,
                           tile_w: int = 32, tile_h: int = 32,
                           capacity: int = 2048, bg=None, span_x: int = 12,
                           span_y: int = 12, pre=None, tiled: bool = False):
    """B frames (mvps (B, 4, 4)) of a batch of textured quads blended back
    to front over an opaque depth — BASELINE config 2 on the binned path:
    one prep pass over the B frames (:func:`prepare_blended_frame`), one
    K7 launch (``tile_raster.raster_tiles_blend_u8``) and one detile.

    Per frame it draws what :func:`render_blended` draws with the faces
    put in :func:`blend_order`'s order: inclusive edges (a quad's
    diagonal is blended twice), affine (u, v) and the nearest clamped
    texel of ``tex_u8`` ((th, tw, 4) uint8) as c / 255, the test
    0 <= z <= ``opaque_depth`` ((H, W) float32; default 1), src-over in
    float32 with alpha = max, from ``bg`` ((4,), default 0), each channel
    then quantised clip(v * 255, 0, 255) truncated.  One op order
    differs: the edges' constants are formed as the u8 entries form them,
    in float64 and rounded once (:func:`edge_coeffs`), where
    :func:`render_blended` forms them in float32; with its constants the
    frames are :func:`render_blended`'s to the bit.  Faces 2q and 2q + 1
    must be quad q (:func:`quad_centres`).

    verts (V, 3), faces (F, 3), uvs (V, 2) are tensors on one device; the
    render runs there.  ``pre``: optional :func:`blend_pre` of the mesh,
    hoisted out of frame loops.  Returns (frames (B, H, W, 4) uint8 — or
    (B, NT, P, 4) when ``tiled`` —, overflow device bool over the batch:
    a run longer than ``capacity`` or a triangle's tile box past
    ``span_x`` x ``span_y``).  No host sync."""
    dev = verts.device
    if bg is None:
        bg = torch.zeros(4, dtype=torch.float32, device=dev)
    if opaque_depth is None:
        opaque_depth = torch.ones((height, width), dtype=torch.float32,
                                  device=dev)
    v4f, fuv, tex_packed, centres = (pre if pre is not None else
                                     blend_pre(verts, faces, uvs, tex_u8))
    prep = prepare_blended_frame(
        verts, faces, fuv, width, height, mvps, centres=centres,
        tile_w=tile_w, tile_h=tile_h, capacity=capacity, span_x=span_x,
        span_y=span_y, v4f=v4f)
    packed = tile_raster.raster_tiles_blend_u8(
        prep["sorted_pad"], prep["starts"], prep["counts"], prep["table"],
        prep["order"], opaque_depth, tex_packed, tuple(tex_u8.shape[:2]),
        torch.as_tensor(bg, dtype=torch.float32, device=dev), width, height,
        tile_w, tile_h)
    if tiled:
        return tile_raster.tiles_u8(packed), prep["overflow"].any()
    return (tile_raster.detile_packed(packed, width, height, tile_w, tile_h),
            prep["overflow"].any())
