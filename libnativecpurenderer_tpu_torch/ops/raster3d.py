"""Mesh -> frame paths of the z-buffered triangle rasterizer, in PyTorch.

Counterpart of ``libnativecpurenderer_tpu/ops/raster3d.py``, restricted to
what the flat binned paths run: projection and 1/256 px snapping
(``setup_triangles``), edge coefficients (``edge_coeffs``), gatherless tile
binning (``bin_triangles_flat``), the Gouraud u8 entries
``render_gouraud_u8[_loop]`` and the textured ones
``render_textured_u8[_loop|_batch]`` (u8 texels) and ``render_textured``
(float texture, with depth).  The per-tile visibility and shading runs in
``tile_raster`` (the hand-written CUDA kernels K1, K3 and K2a, or their
plain versions for CPU tensors).

Every function runs on the device of the tensors it is given.  The op
order follows the JAX code op for op, and no step fuses a multiply into an
add: eager torch rounds each elementwise op, on the CPU and on the card
alike, so the CPU tests here and the card's run compute the same bits.
Visibility is the same packed-key minimum as in the JAX package:
``(quantised_z << IDX_BITS) | slot`` per covered pixel, lowest key wins.
"""

from __future__ import annotations

import numpy as np
import torch

# packed-key constants, as in raster3d.py:38-44
IDX_BITS = 18          # up to 256k triangles per draw
IDX_MASK = (1 << IDX_BITS) - 1
Z_LEVELS = (1 << (31 - IDX_BITS)) - 1   # 13 bits of depth quantisation
NO_TRI = IDX_MASK      # sentinel triangle id (background)
SKY_KEY = (Z_LEVELS << IDX_BITS) | NO_TRI
SUBPIXEL = 256.0       # screen coords snap to 1/256 px


def _snap(c):
    """Snap a screen coordinate to the 1/256 subpixel grid
    (``raster3d.py:47-59``).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    return torch.round(c * SUBPIXEL) / SUBPIXEL


def _to_i32(x):
    """float -> int32 as XLA converts (``.astype(jnp.int32)``): truncate
    toward zero, saturate out of range, NaN -> 0.  ``Tensor.to(int32)``
    leaves those cases undefined (the CPU gives INT_MIN).  2**31 - 128 is
    the largest float32 below 2**31, 2**31 - 1 the largest float64 that
    truncates into range."""
    hi = 2.0 ** 31 - (1 if x.dtype == torch.float64 else 128)
    y = torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, hi)
    return torch.where(x >= 2.0 ** 31, torch.iinfo(torch.int32).max,
                       y.to(torch.int32))


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
    is ((v0 m_r0 + v1 m_r1) + v2 m_r2) + v3 m_r3."""
    m = mvp.to(dtype=v4f.dtype, device=v4f.device)
    return (((v4f[..., 0:1] * m[:, 0] + v4f[..., 1:2] * m[:, 1])
             + v4f[..., 2:3] * m[:, 2]) + v4f[..., 3:4] * m[:, 3])


def setup_triangles(verts, faces, mvp, width: int, height: int, v4f=None):
    """Transform + project + snap (``raster3d.py:76-114``).

    verts: (V, 3) float; faces: (F, 3) int; mvp: (4, 4).  ``v4f``:
    optional (F, 3, 4) rows from :func:`pregather_mesh`.  Returns a dict
    of per-face tensors: sxy (F, 3, 2) snapped screen positions, z (F, 3)
    depth in [0, 1] for in-frustum vertices, valid (F,) bool (every
    vertex in front of w = 1e-6), inv_w (F, 3)."""
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
    valid = w_ok.all(dim=1)
    sxy = torch.stack([fsx, fsy], dim=-1)
    inv_w = (1.0 / wsafe)[..., 0]
    return {"sxy": sxy, "z": fz, "valid": valid, "inv_w": inv_w}


def edge_coeffs(sxy, z, valid):
    """Edge-function coefficients (``raster3d.py:215-237``).

    Edge i is opposite vertex i: e_i(x, y) = A_i x + B_i y + C_i equals
    the barycentric weight of vertex i times the signed doubled area.
    Returns (A, B, C) each (F, 3), inv_area (F,), sign (F,) and valid
    (F,) with degenerate triangles cleared."""
    x0, y0 = sxy[:, 0, 0], sxy[:, 0, 1]
    x1, y1 = sxy[:, 1, 0], sxy[:, 1, 1]
    x2, y2 = sxy[:, 2, 0], sxy[:, 2, 1]
    A = torch.stack([y1 - y2, y2 - y0, y0 - y1], -1)
    B = torch.stack([x2 - x1, x0 - x2, x1 - x0], -1)
    C = torch.stack([x1 * y2 - x2 * y1,
                     x2 * y0 - x0 * y2,
                     x0 * y1 - x1 * y0], -1)
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    nz = area2.abs() > 1e-12
    valid = valid & nz
    inv_area = torch.where(nz, 1.0 / torch.where(nz, area2, 1.0), 0.0)
    sign = torch.sign(area2)
    return A, B, C, inv_area, sign, valid


def bin_triangles_flat(sxy, valid, width: int, height: int, tile_w: int,
                       tile_h: int, block_k: int, span_x: int = 8,
                       span_y: int = 8, edges=None):
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

    ``lax.top_k`` becomes ``torch.topk``; the two break ties in another
    order, which changes which sentinel slots the tail holds but no valid
    pair: an unchosen triangle with span <= SY_A emits no extra valid
    pair, and a chosen one beyond it raises the flag in both."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    nt = ntx * nty
    F = sxy.shape[0]
    dev = sxy.device
    i32 = torch.int32
    xs = sxy[..., 0]
    ys = sxy[..., 1]
    # divisors as device tensors: CUDA torch divides by a Python scalar
    # as a multiply by its reciprocal, inexact for a tile size not a power
    # of 2 (torch.full fills on the device: no copy, no host sync)
    tw = torch.full((), float(tile_w), dtype=sxy.dtype, device=dev)
    th = torch.full((), float(tile_h), dtype=sxy.dtype, device=dev)
    x0 = _to_i32(torch.floor(xs.amin(dim=1) / tw))
    x1 = _to_i32(torch.floor(xs.amax(dim=1) / tw))
    y0 = _to_i32(torch.floor(ys.amin(dim=1) / th))
    y1 = _to_i32(torch.floor(ys.amax(dim=1) / th))
    x0c = x0.clamp(min=0)
    y0c = y0.clamp(min=0)
    x1c = x1.clamp(max=ntx - 1)
    y1c = y1.clamp(max=nty - 1)
    nonempty = valid & (x0c <= x1c) & (y0c <= y1c)
    span_overflow = (nonempty & ((x1c - x0c >= span_x)
                                 | (y1c - y0c >= span_y))).any()

    if nt >= (1 << (31 - IDX_BITS)):
        raise ValueError(f"{nt} tiles is too many for packed binning")

    def emit(y0c_, x0c_, x1c_, y1c_, ne_, tri_ids, dy0: int, sy_n: int,
             edges_):
        """Packed pairs for tile rows y0c_+dy0 .. +sy_n-1 x columns
        x0c_ .. +span_x-1 of the given triangles, built (sy, sx, n)."""
        dx = torch.arange(span_x, dtype=i32, device=dev)
        dyv = dy0 + torch.arange(sy_n, dtype=i32, device=dev)
        txs = x0c_[None, :] + dx[:, None]            # (sx, n)
        tys = y0c_[None, :] + dyv[:, None]           # (sy, n)
        ok = (ne_[None, None, :]
              & (txs[None, :, :] <= x1c_[None, None, :])
              & (tys[:, None, :] <= y1c_[None, None, :]))
        if edges_ is not None:
            # edge-vs-tile cull (raster3d.py:498-533): an edge's maximum
            # over the tile's pixel rectangle sits at the corner its
            # coefficient signs pick; the slack covers f32 rounding
            A, B, C, sign = edges_
            dtype = A.dtype
            fxl = (txs * tile_w).to(dtype)          # (sx, n)
            fyl = (tys * tile_h).to(dtype)          # (sy, n)
            fxh = fxl + (tile_w - 1)
            fyh = fyl + (tile_h - 1)
            cover = None
            for e in range(3):
                Ae = (A[:, e] * sign)[None, :]
                Be = (B[:, e] * sign)[None, :]
                Ce = (C[:, e] * sign)[None, :]
                ex = torch.maximum(Ae * fxh, Ae * fxl)      # (sx, n)
                ey = torch.maximum(Be * fyh, Be * fyl)      # (sy, n)
                emax = (ey[:, None, :] + ex[None, :, :]
                        + Ce[None, None, :])
                slack = ((Ae.abs() * fxh)[None, :, :]
                         + (Be.abs() * fyh)[:, None, :]
                         + Ce.abs()[None, None, :])
                keep = emax >= -1e-5 * slack
                cover = keep if cover is None else (cover & keep)
            ok = ok & cover
        tid = tys[:, None, :] * ntx + txs[None, :, :]
        tid = torch.where(ok, tid, nt)
        return ((tid << IDX_BITS) | tri_ids[None, None, :]).reshape(-1)

    # tall split (raster3d.py:539-615): a base box of SY_A rows for every
    # triangle, the remaining rows only for the top-TK tallest
    SY_A = 4
    all_tris = torch.arange(F, dtype=i32, device=dev)
    if F >= 4096 and span_y > SY_A:
        TK = min(4096 if span_y >= 8 else 2048, F)
        pieces = [emit(y0c, x0c, x1c, y1c, nonempty, all_tris, 0, SY_A,
                       edges)]
        spans = torch.where(nonempty, y1c - y0c + 1, 0)
        tall_span, idx = torch.topk(spans, TK)
        span_overflow = span_overflow | (tall_span[-1] > SY_A)
        ed = (tuple(e[idx] for e in edges) if edges is not None else None)
        pieces.append(emit(y0c[idx], x0c[idx], x1c[idx], y1c[idx],
                           nonempty[idx], idx.to(i32), SY_A, span_y - SY_A,
                           ed))
    else:
        pieces = [emit(y0c, x0c, x1c, y1c, nonempty, all_tris, 0, span_y,
                       edges)]
    S = sum(p.shape[0] for p in pieces)
    spad = (S // block_k + 3) * block_k
    pad_val = (nt << IDX_BITS) | F
    pieces.append(torch.full((spad - S,), pad_val, dtype=i32, device=dev))
    sorted_pad = torch.sort(torch.cat(pieces)).values
    tid_sorted = sorted_pad >> IDX_BITS
    starts = torch.searchsorted(
        tid_sorted, torch.arange(nt + 1, dtype=i32, device=dev),
        out_int32=True)
    counts = starts[1:] - starts[:-1]
    overflow = span_overflow | (counts > block_k).any()
    return sorted_pad, starts[:-1].contiguous(), counts, overflow


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


def _prep_geometry(verts, faces, mvp, width: int, height: int, *,
                   tile_w: int, tile_h: int, capacity: int, span_x: int,
                   span_y: int, z_clip: bool, v4f=None):
    """What the Gouraud and textured per-frame preps share: projection,
    edges and binning, with ``z_clip=False``'s check that every valid
    vertex z lies in [0, 1] (the condition under which skipping the
    per-pixel z test is sound, ``raster3d.py:917-925,1225-1233``) folded
    into the overflow flag.  Returns (tri, (A, B, C, zsc, inv_area, sign,
    valid), {sorted_pad, starts, counts, overflow})."""
    tri = setup_triangles(verts, faces, mvp, width, height, v4f=v4f)
    A, B, C, inv_area, sign, valid = edge_coeffs(tri["sxy"], tri["z"],
                                                 tri["valid"])
    zsc = tri["z"] * inv_area[:, None]
    sorted_pad, starts, counts, overflow = bin_triangles_flat(
        tri["sxy"], valid, width, height, tile_w, tile_h, capacity,
        span_x, span_y, edges=(A, B, C, sign))
    if not z_clip:
        z = tri["z"]
        z_ok = torch.where(tri["valid"][:, None], (z >= 0.0) & (z <= 1.0),
                           True).all()
        overflow = overflow | ~z_ok
    return tri, (A, B, C, zsc, inv_area, sign, valid), {
        "sorted_pad": sorted_pad, "starts": starts, "counts": counts,
        "overflow": overflow}


def prepare_frame(verts, faces, vtx_colors, width: int, height: int,
                  mvp=None, *, tile_w: int = 128, tile_h: int = 16,
                  capacity: int = 512, bg=None, span_x: int = 8,
                  span_y: int = 8, z_clip: bool = True, pre=None):
    """Per-frame prep of :func:`render_gouraud_u8`, everything before the
    tile kernel (``raster3d.py:895-934``): returns a dict with the
    kernel's inputs ``sorted_pad``, ``starts``, ``counts``, ``table``,
    ``packed_bg`` and the device ``overflow`` flag, which with
    ``z_clip=False`` also carries the vertex-z check (see
    :func:`_prep_geometry`)."""
    from . import tile_raster
    dtype = verts.dtype
    if mvp is None:
        mvp = torch.eye(4, dtype=dtype, device=verts.device)
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=verts.device)
    if pre is not None:
        v4f, attrs = pre
    else:
        v4f, attrs = None, vtx_colors[faces]
    _, edges, prep = _prep_geometry(
        verts, faces, mvp, width, height, tile_w=tile_w, tile_h=tile_h,
        capacity=capacity, span_x=span_x, span_y=span_y, z_clip=z_clip,
        v4f=v4f)
    prep["table"] = tile_raster.build_table(*edges, attrs)
    prep["packed_bg"] = tile_raster.pack_bg(bg)
    return prep


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
                           v4f=None):
    """Per-frame prep of the textured entries, everything before the tile
    kernel — counterpart of ``_tex_prep`` (``raster3d.py:1208-1250``,
    without ``mxu``).  ``fuv`` is ``uvs[faces]``, (F, 3, 2).  The row
    table carries the attributes [u/w, v/w, 1/w, 1], or [u, v, 1, 1]
    without ``perspective_correct``.  Returns a dict with ``sorted_pad``,
    ``starts``, ``counts``, ``table`` and the device ``overflow`` flag
    (with ``z_clip=False`` also the vertex-z check, see
    :func:`_prep_geometry`)."""
    from . import tile_raster
    tri, edges, prep = _prep_geometry(
        verts, faces, mvp, width, height, tile_w=tile_w, tile_h=tile_h,
        capacity=capacity, span_x=span_x, span_y=span_y, z_clip=z_clip,
        v4f=v4f)
    if perspective_correct:
        iw = tri["inv_w"][..., None]
        attrs = torch.cat([fuv * iw, iw, torch.ones_like(iw)], dim=-1)
    else:
        attrs = torch.cat([fuv, torch.ones_like(fuv)], dim=-1)
    prep["table"] = tile_raster.build_table(*edges, attrs)
    return prep


def render_gouraud_u8(verts, faces, vtx_colors, width: int, height: int,
                      mvp=None, *, tile_w: int = 128, tile_h: int = 16,
                      capacity: int = 512, bg=None, span_x: int = 8,
                      span_y: int = 8, kcc: int = 32, opaque: bool = False,
                      z_clip: bool = True, pre=None, tiled: bool = False):
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
    out of frame loops.  ``kcc`` is accepted for signature parity: it
    sized the TPU kernel's triangle chunk and changes no value.  The
    TPU layout knobs of the JAX entry (``interpret``, ``resident_out``,
    ``mega``, ``wf``, ``out8``, ``ktail``, ``mxu``) are not parameters."""
    from . import tile_raster
    prep = prepare_frame(verts, faces, vtx_colors, width, height, mvp,
                         tile_w=tile_w, tile_h=tile_h, capacity=capacity,
                         bg=bg, span_x=span_x, span_y=span_y,
                         z_clip=z_clip, pre=pre)
    packed = tile_raster.raster_tiles_flat_u8(
        prep["sorted_pad"], prep["starts"], prep["counts"], prep["table"],
        prep["packed_bg"], width, tile_w, tile_h, opaque=opaque,
        z_clip=z_clip)
    if tiled:
        return tile_raster.tiles_u8(packed), prep["overflow"]
    return (tile_raster.detile_packed(packed, width, height, tile_w,
                                      tile_h), prep["overflow"])


def render_gouraud_u8_loop(verts, faces, vtx_colors, width: int,
                           height: int, mvps, *, tile_w: int = 32,
                           tile_h: int = 32, capacity: int = 1024, bg=None,
                           span_x: int = 5, span_y: int = 3, kcc: int = 32,
                           opaque: bool = True, z_clip: bool = False,
                           tiled: bool = False):
    """B frames of :func:`render_gouraud_u8` (mvps (B, 4, 4)), the
    per-face gathers hoisted out of the loop — counterpart of
    ``render_gouraud_pallas_loop`` (``raster3d.py:1083-1136``), with its
    production defaults ((32, 32) tiles, span (5, 3), capacity 1024,
    opaque, z_clip off).  Returns (frames (B, H, W, 4) uint8 — or
    (B, NT, P, 4) when ``tiled`` — , overflow device bool over the
    batch).  No host sync: frames and flag stay on the device."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    dev = verts.device
    pre = (pregather_mesh(verts, faces), vtx_colors[faces])
    n = mvps.shape[0]
    shape = ((n, ntx * nty, tile_h * tile_w, 4) if tiled
             else (n, height, width, 4))
    frames = torch.empty(shape, dtype=torch.uint8, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(n):
        frames[i], ovf = render_gouraud_u8(
            verts, faces, vtx_colors, width, height, mvps[i],
            tile_w=tile_w, tile_h=tile_h, capacity=capacity, bg=bg,
            span_x=span_x, span_y=span_y, kcc=kcc, opaque=opaque,
            z_clip=z_clip, pre=pre, tiled=tiled)
        overflow = overflow | ovf
    return frames, overflow


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
    from . import tile_raster
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
        perspective_correct=perspective_correct, z_clip=z_clip, v4f=v4f)
    packed = tile_raster.raster_tiles_tex_u8(
        prep["sorted_pad"], prep["starts"], prep["counts"], prep["table"],
        tex_packed, tuple(tex_u8.shape[:2]), tile_raster.pack_bg(bg), width,
        tile_w, tile_h, z_clip=z_clip)
    if tiled:
        return tile_raster.tiles_u8(packed), prep["overflow"]
    return (tile_raster.detile_packed(packed, width, height, tile_w,
                                      tile_h), prep["overflow"])


def render_textured_u8_loop(verts, faces, uvs, tex_u8, width: int,
                            height: int, mvps, *, tile_w: int = 32,
                            tile_h: int = 32, capacity: int = 1024,
                            bg=None, span_x: int = 5, span_y: int = 3,
                            kcc: int = 32, perspective_correct: bool = True,
                            z_clip: bool = True, tiled: bool = False):
    """B frames of :func:`render_textured_u8` (mvps (B, 4, 4)), the
    per-face gathers and the packed texture made once, outside the frame
    loop — counterpart of ``render_textured_pallas_loop``
    (``raster3d.py:1432-1517``) with its production defaults ((32, 32)
    tiles, span (5, 3), capacity 1024, perspective-correct, z_clip on).
    Returns (frames (B, H, W, 4) uint8 — or (B, NT, P, 4) when
    ``tiled`` — , overflow device bool over the batch).  No host sync."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    dev = verts.device
    pre = (pregather_mesh(verts, faces), uvs[faces], pack_texture_u8(tex_u8))
    n = mvps.shape[0]
    shape = ((n, ntx * nty, tile_h * tile_w, 4) if tiled
             else (n, height, width, 4))
    frames = torch.empty(shape, dtype=torch.uint8, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(n):
        frames[i], ovf = render_textured_u8(
            verts, faces, uvs, tex_u8, width, height, mvps[i],
            tile_w=tile_w, tile_h=tile_h, capacity=capacity, bg=bg,
            span_x=span_x, span_y=span_y, kcc=kcc,
            perspective_correct=perspective_correct, z_clip=z_clip,
            pre=pre, tiled=tiled)
        overflow = overflow | ovf
    return frames, overflow


def render_textured_u8_batch(verts, faces, uvs, tex_u8, width: int,
                             height: int, mvps, *, tile_w: int = 32,
                             tile_h: int = 32, capacity: int = 512,
                             bg=None, span_x: int = 5, span_y: int = 3,
                             kcc: int = 16, perspective_correct: bool = True,
                             z_clip: bool = True, tiled: bool = False):
    """:func:`render_textured_u8_loop` under the defaults of
    ``render_textured_pallas_batch`` (``raster3d.py:1344-1425``: capacity
    512, kcc 16) — an alias kept for the JAX entry's name, not a path of
    its own: the same loop and the same values (the JAX entry's vmapped
    prep was a TPU program layout)."""
    return render_textured_u8_loop(
        verts, faces, uvs, tex_u8, width, height, mvps, tile_w=tile_w,
        tile_h=tile_h, capacity=capacity, bg=bg, span_x=span_x,
        span_y=span_y, kcc=kcc, perspective_correct=perspective_correct,
        z_clip=z_clip, tiled=tiled)


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
    from . import tile_raster
    dtype = verts.dtype
    dev = verts.device
    if mvp is None:
        mvp = torch.eye(4, dtype=dtype, device=dev)
    if bg is None:
        bg = torch.zeros(4, dtype=dtype, device=dev)
    prep = prepare_textured_frame(
        verts, faces, uvs[faces], width, height, mvp, tile_w=tile_w,
        tile_h=tile_h, capacity=capacity, span_x=span_x, span_y=span_y,
        perspective_correct=perspective_correct, z_clip=True)
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
    # the divisor is a tensor: CUDA divides by a Python scalar as a
    # multiply by its reciprocal
    zq = (keys >> IDX_BITS).to(dtype) / torch.full(
        (), Z_LEVELS, dtype=dtype, device=dev)
    return rgba, zq, prep["overflow"]
