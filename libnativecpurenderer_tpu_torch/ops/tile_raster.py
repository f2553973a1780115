"""Per-tile visibility + Gouraud shading to packed u8: kernel K1.

Counterpart of ``libnativecpurenderer_tpu/ops/pallas_raster.py`` for the
flat u8 path: the row table (``build_table``, ``pallas_raster.py:1445``),
the packed background (``_pack_bg``, ``:932``), the detile
(``_detile_plane``/``_detile_packed``, ``:939-950``) and the tile kernel
launched by ``raster_tiles_flat(u8=True)`` (``:793``; kernel body
``_make_kernel_flat`` ``:125-354``, u8 epilogue ``:566-596``) through
``render_binned_pallas_flat_u8`` (``:953-1007``).

``raster_tiles_flat_u8`` is the wrapper: on CUDA tensors it launches the
hand-written kernel in ``csrc/tile_raster.cu`` (or raises), on CPU
tensors it runs ``raster_tiles_flat_u8_reference``, the plain torch
version in the same operation order.  The two are bit-identical on the
card.  The wrapper counts its kernel launches in
``raster_tiles_flat_u8.launches``.

Row table layout (32 floats per triangle, ``pallas_raster.py:18-27``):
  0:9   A0' B0' C0' A1' B1' C1' A2' B2' C2'  (edges, cover sign folded in)
  9:12  z_i * inv_area * sign
  12    sign   13 inv_area
  14:26 vertex attributes * inv_area * sign, vertex-major (14 + 4 i + d)
  26:32 zero padding
Invalid triangles and the pad row F are NaN rows: every comparison with a
NaN edge is false, so they never cover a pixel.
"""

from __future__ import annotations

import torch

from .raster3d import IDX_BITS, IDX_MASK, SKY_KEY, Z_LEVELS

ROW_W = 32      # padded row width
D = 4           # RGBA
MAX_P = 4096    # pixels per tile the kernel takes (16 per thread)
REF_CHUNK = 16  # run slots the plain version evaluates per pass
_ALPHA_255 = -(1 << 24)   # 255 << 24 as an int32


def build_table(A, B, C, zplane_scaled, inv_area, sign, valid, attrs):
    """Edge-major float32 row table, (F + 1, ROW_W), NaN rows for invalid
    triangles and for the pad row F (``pallas_raster.py:1445-1471``)."""
    F = A.shape[0]
    sg = sign[:, None]
    As = A * sg
    Bs = B * sg
    Cs = C * sg
    table = torch.stack([As[:, 0], Bs[:, 0], Cs[:, 0],
                         As[:, 1], Bs[:, 1], Cs[:, 1],
                         As[:, 2], Bs[:, 2], Cs[:, 2]], dim=1)
    attrs_sc = attrs * (inv_area * sign)[:, None, None]
    table = torch.cat([table, zplane_scaled * sg, sg, inv_area[:, None],
                       attrs_sc.reshape(F, 3 * D)], dim=1)
    table = torch.where(valid[:, None], table, float("nan")).to(
        torch.float32)
    table = torch.cat([table, table.new_full((1, table.shape[1]),
                                             float("nan"))], dim=0)
    return torch.nn.functional.pad(table, (0, ROW_W - table.shape[1]))


def _quant_u8(v):
    """clip(v * 255, 0, 255) truncated to int32 (the kernel epilogue)."""
    return torch.clamp(v * 255.0, 0.0, 255.0).to(torch.int32)


def pack_bg(bg):
    """Background RGBA -> (1,) int32 packed r | g<<8 | b<<16 | a<<24 on
    bg's device, quantised like the kernel epilogue
    (``pallas_raster.py:932-936``)."""
    q = _quant_u8(bg)
    return (q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24)).reshape(1)


def tiles_u8(packed):
    """(NT, P) packed int32 -> (NT, P, 4) uint8 (little-endian: r first)."""
    return packed.view(torch.uint8).reshape(packed.shape[0], -1, 4)


def detile_packed(packed, width: int, height: int, tile_w: int,
                  tile_h: int):
    """(NT, P) packed int32 tiles -> (H, W, 4) uint8 raster order,
    cropping padded slots (``pallas_raster.py:939-950``)."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    p2 = packed.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3)
    p2 = p2.reshape(nty * tile_h, ntx * tile_w)[:height, :width]
    return p2.contiguous().view(torch.uint8).reshape(height, width, 4)


def _check_inputs(sorted_pad, starts, counts, table, packed_bg, tile_w,
                  tile_h):
    dev = table.device
    for name, t, dtype in (("sorted_pad", sorted_pad, torch.int32),
                           ("starts", starts, torch.int32),
                           ("counts", counts, torch.int32),
                           ("table", table, torch.float32),
                           ("packed_bg", packed_bg, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sorted_pad.dim() != 1 or sorted_pad.shape[0] == 0:
        raise ValueError(f"sorted_pad must be a non-empty 1-D array, got "
                         f"{tuple(sorted_pad.shape)}")
    if starts.dim() != 1 or counts.shape != starts.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and counts "
                         f"{tuple(counts.shape)} must be the same (NT,)")
    if table.dim() != 2 or table.shape[1] != ROW_W or table.shape[0] < 1:
        raise ValueError(f"table must be (F + 1, {ROW_W}), got "
                         f"{tuple(table.shape)}")
    if packed_bg.shape != (1,):
        raise ValueError(f"packed_bg must be (1,), got "
                         f"{tuple(packed_bg.shape)}")
    if not 0 < tile_w * tile_h <= MAX_P:
        raise ValueError(f"tile {tile_w}x{tile_h} must hold 1..{MAX_P} "
                         f"pixels")


def raster_tiles_flat_u8(sorted_pad, starts, counts, table, packed_bg,
                         width: int, tile_w: int, tile_h: int, *,
                         opaque: bool, z_clip: bool):
    """Kernel K1: one packed u8 RGBA int32 per pixel of every tile,
    (NT, P) with P = tile_w * tile_h.  Counterpart of
    ``render_binned_pallas_flat_u8`` (``pallas_raster.py:953-1007``) up to
    the detile, taking ``starts``/``counts`` directly (no TPU block
    windows).

    For tile t and slot p at pixel (ox + p % tile_w, oy + p // tile_w),
    walk the run ``sorted_pad[starts[t] : starts[t] + counts[t]]`` in
    order; for each triangle row evaluate e_i = (A_i x + B_i y) + C_i,
    cover when all e_i >= 0 (and 0 <= z <= 1 with ``z_clip``), key =
    (int(z * Z_LEVELS) << IDX_BITS) | slot, keep the strict minimum (the
    lower slot wins a tie).  The winner's RGBA is
    (e0 a0 + e1 a1) + e2 a2 per channel, packed after clip(v * 255, 0,
    255) truncation, alpha 255 with ``opaque``; tiles' slots no triangle
    covers get ``packed_bg[0]``.

    CUDA tensors launch the kernel on the current stream (no sync);
    CPU tensors run :func:`raster_tiles_flat_u8_reference`."""
    _check_inputs(sorted_pad, starts, counts, table, packed_bg, tile_w,
                  tile_h)
    dev = table.device
    if dev.type == "cpu":
        return raster_tiles_flat_u8_reference(
            sorted_pad, starts, counts, table, packed_bg, width, tile_w,
            tile_h, opaque=opaque, z_clip=z_clip)
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    from . import _kernels
    nt = starts.shape[0]
    ntx = (width + tile_w - 1) // tile_w
    out = torch.empty((nt, tile_w * tile_h), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _kernels.launch_tile_raster_u8(
            sorted_pad.data_ptr(), sorted_pad.shape[0], starts.data_ptr(),
            counts.data_ptr(), nt, table.data_ptr(), table.shape[0],
            packed_bg.data_ptr(), out.data_ptr(), ntx, tile_w, tile_h,
            opaque, z_clip, stream)
    raster_tiles_flat_u8.launches += 1
    return out


raster_tiles_flat_u8.launches = 0


def _edges(r, X, Y):
    """e_i = (A_i x + B_i y) + C_i of the three sign-folded edges; r[..., k]
    is row column k, broadcast against the pixel coordinates X, Y."""
    return [r[..., 3 * i] * X + r[..., 3 * i + 1] * Y + r[..., 3 * i + 2]
            for i in range(3)]


def raster_tiles_flat_u8_reference(sorted_pad, starts, counts, table,
                                   packed_bg, width: int, tile_w: int,
                                   tile_h: int, *, opaque: bool,
                                   z_clip: bool):
    """Plain torch version of K1, same values bit for bit, vectorised
    over tiles and pixels: the minimum key over the run is found
    ``REF_CHUNK`` slots at a time, then the winner's row is fetched again and shaded.
    Every quantity is the kernel's expression in the kernel's order, so
    the recomputed edge values equal those of the walk."""
    nt = starts.shape[0]
    P = tile_w * tile_h
    ntx = (width + tile_w - 1) // tile_w
    dev = table.device
    i32 = torch.int32
    last_slot = sorted_pad.shape[0] - 1
    last_row = table.shape[0] - 1
    t = torch.arange(nt, dtype=i32, device=dev)
    p = torch.arange(P, dtype=i32, device=dev)
    X = ((t % ntx * tile_w)[:, None] + p % tile_w).to(torch.float32)
    Y = ((t // ntx * tile_h)[:, None] + p // tile_w).to(torch.float32)

    def rows_at(slots):
        idx = (starts.reshape((nt,) + (1,) * (slots.dim() - 1))
               + slots).clamp(max=last_slot).long()
        tri = (sorted_pad[idx] & IDX_MASK).clamp(max=last_row)
        return table[tri.long()]

    best = torch.full((nt, P), SKY_KEY, dtype=i32, device=dev)
    kmax = int(counts.max()) if nt else 0
    for base in range(0, kmax, REF_CHUNK):
        j = base + torch.arange(REF_CHUNK, dtype=i32, device=dev)  # (ck,)
        r = rows_at(j[None, :])[:, :, None, :]          # (NT, ck, 1, 32)
        e0, e1, e2 = _edges(r, X[:, None, :], Y[:, None, :])  # (NT, ck, P)
        zz = e0 * r[..., 9] + e1 * r[..., 10] + e2 * r[..., 11]
        cov = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        if z_clip:
            cov = cov & (zz >= 0.0) & (zz <= 1.0)
        cov = cov & (j[None, :] < counts[:, None])[..., None]
        keys = ((zz * Z_LEVELS).to(i32) << IDX_BITS) | j[None, :, None]
        keys = torch.where(cov, keys, SKY_KEY)
        best = torch.minimum(best, keys.amin(dim=1))

    hit = best != SKY_KEY
    slot = torch.where(hit, best & IDX_MASK, 0)
    r = rows_at(slot)                                    # (NT, P, 32)
    e0, e1, e2 = _edges(r, X, Y)                         # (NT, P)
    q = [_quant_u8(e0 * r[..., 14 + d] + e1 * r[..., 14 + D + d]
                   + e2 * r[..., 14 + 2 * D + d])
         for d in range(3 if opaque else 4)]
    a8 = _ALPHA_255 if opaque else q[3] << 24
    packed = q[0] | (q[1] << 8) | (q[2] << 16) | a8
    return torch.where(hit, packed, packed_bg)
