"""Per-tile visibility and its epilogues: kernels K1, K3, K2b, K2a, K5, K6,
K1-wf and K1-mxu; and the ordered blend walk K7.

Counterpart of ``libnativecpurenderer_tpu/ops/pallas_raster.py``: the row
table (``build_table``, ``pallas_raster.py:1445``), the packed background
(``_pack_bg``, ``:932``), the detiles (``_detile_plane``/``_detile_packed``/
``_detile``, ``:939-950,1508``), the entries ``render_binned_pallas_flat``
(``:909``), ``render_binned_pallas_flat_batch`` (``:1354``),
``render_binned_pallas_flat_batch_u8`` (``:1010``),
``render_binned_tex_idx_batch`` (``:1048``), ``render_binned_pallas``
(``:1559``), ``render_binned_pallas_batch`` (``:1526``) and
``render_binned_dynrows_batch_u8`` (``:1302``), the affine table
(``build_table_mxu``, ``:1474``), and the TPU tile kernels, as the
kernels their launchers pick:

  * K1, ``raster_tiles_flat_u8``: packed u8 Gouraud RGBA (``u8=True``,
    ``raster_tiles_flat`` ``:793``, epilogue ``:566-596``);
  * K3, ``raster_tiles_tex_u8``: the packed u8 texel of the winner's
    clamped-nearest (u, v) (``raster_tiles_tex`` ``:895``, epilogue
    ``:375-565``);
  * K2b, ``raster_tiles_tex_idx``: that texel's index, -1 for sky
    (``tex_dims``, ``:793``, epilogue ``:356-374``);
  * K2a, ``raster_tiles_keys_f32``: packed depth keys and the four f32
    attributes (the f32 branch, ``:805``, epilogue ``:597-599``);
  * K5, ``raster_tiles_bins_f32``: K2a's outputs over a materialised bins
    row (``raster_tiles`` ``:1396-1442``, body ``_make_kernel`` ``:51-122``);
  * K6, ``raster_tiles_rows_u8``: K1's opaque values over rows gathered in
    pair order (``raster_tiles_dynrows`` ``:1271-1299``, body
    ``_make_kernel_dynrows`` ``:1176-1267``);
  * K1-wf, ``raster_tiles_flat_u8_wf``: K1's values from K1's split
    walk whose blocks claim ``wf`` consecutive items at a time (the
    ``wf`` branch, ``:739``, kernel ``kernel_wf`` ``:624-655``);
  * K1-mxu, ``raster_tiles_flat_u8_mxu`` and ``raster_tiles_tex_u8_mxu``:
    the split walk over an affine table (``build_table_mxu``, ``:1474``)
    with the walk's planes evaluated on the tensor cores (the ``mxu``
    branch of ``_make_kernel_flat``, ``:242-250,285-301,326-327``), K1's
    and K3's epilogues on the winner's attribute planes, evaluated on the
    CUDA cores (:func:`mma_operands` builds the product's operands);

and K7, ``raster_tiles_blend_u8`` (``csrc/tile_blend.cu``, no TPU kernel:
the JAX package blends with a scan of XLA ops): each tile's run, listed
in draw order, alpha-blended in order over a blend table
(:func:`build_blend_table`), z-tested against an opaque depth.

Each wrapper, on CUDA tensors, launches the hand-written kernel in
``csrc/tile_raster.cu`` (one walk; the epilogue and the row source are
template parameters; K7's in ``csrc/tile_blend.cu``) or raises; on CPU
tensors it runs its ``*_reference``, the plain torch version in the same
operation order, bit-identical to the kernel on the card (the
matrix-unit walk's within a tolerance: the tensor cores do not round
each sum to nearest).  Each
wrapper counts its kernel launches in its ``launches`` attribute.  The
walks over pairs and rows take one frame or B frames (a leading B on
each input) in one launch.

Row table layout (32 floats per triangle, ``pallas_raster.py:18-27``):
  0:9   A0' B0' C0' A1' B1' C1' A2' B2' C2'  (edges, cover sign folded in)
  9:12  z_i * inv_area * sign
  12    sign   13 inv_area
  14:26 vertex attributes * inv_area * sign, vertex-major (14 + 4 i + d)
  26:32 zero padding
Invalid triangles and the pad row F are NaN rows: every comparison with a
NaN edge is false, so they never cover a pixel.  The textured tables carry
the attributes [u/w, v/w, 1/w, 1] (affine: [u, v, 1, 1]).
"""

from __future__ import annotations

import torch

from .sampling import _to_i32

# the packed keys of every walk and entry, (quantised_z << IDX_BITS) | slot
# (the JAX package's raster3d.py:38-44)
IDX_BITS = 18          # up to 256k triangles per draw
IDX_MASK = (1 << IDX_BITS) - 1
Z_LEVELS = (1 << (31 - IDX_BITS)) - 1   # 13 bits of depth quantisation
NO_TRI = IDX_MASK      # sentinel triangle id (background)
SKY_KEY = (Z_LEVELS << IDX_BITS) | NO_TRI
ROW_W = 32      # padded row width
D = 4           # attributes per vertex
MAX_P = 4096    # pixels per tile the kernel takes (16 per thread)
REF_CHUNK = 16  # run slots the plain versions evaluate per pass
SEG = 64        # the split walk (every tile kernel): run slots an item
                # walks (S), the kernel's compile-time SEG
WARPS = 8       # warps a block of the kernel (256 threads)
BOX_W = 16      # K5's and K2a's warp boxes: the columns a warp owns, at
BOX_TILE_W = BOX_W * WARPS   # tiles this wide (the kernel's BOX_TILE_W)
_ALPHA_255 = -(1 << 24)   # 255 << 24 as an int32


def build_table(A, B, C, zplane_scaled, inv_area, sign, valid, attrs):
    """Edge-major float32 row table, (F + 1, ROW_W), NaN rows for invalid
    triangles and for the pad row F (``pallas_raster.py:1445-1471``); B
    frames' edges (a leading B on each, ``attrs`` (F, 3, D) or
    (B, F, 3, D)) give (B, F + 1, ROW_W)."""
    sg = sign[..., None]
    As = A * sg
    Bs = B * sg
    Cs = C * sg
    table = torch.stack([As[..., 0], Bs[..., 0], Cs[..., 0],
                         As[..., 1], Bs[..., 1], Cs[..., 1],
                         As[..., 2], Bs[..., 2], Cs[..., 2]], dim=-1)
    attrs_sc = attrs * (inv_area * sign)[..., None, None]
    table = torch.cat([table, zplane_scaled * sg, sg, inv_area[..., None],
                       attrs_sc.flatten(-2)], dim=-1)
    table = torch.where(valid[..., None], table, float("nan")).to(
        torch.float32)
    table = torch.cat([table, table.new_full(
        table.shape[:-2] + (1, table.shape[-1]), float("nan"))], dim=-2)
    return torch.nn.functional.pad(table, (0, ROW_W - table.shape[-1]))


def build_table_mxu(A, B, C, zplane_scaled, inv_area, sign, valid, attrs):
    """Affine-plane float32 row table of the matrix-unit walk, (F + 1,
    ROW_W), NaN rows for invalid triangles and for the pad row F
    (``pallas_raster.build_table_mxu``, ``:1474-1505``); B frames' edges
    give (B, F + 1, ROW_W), as in :func:`build_table`.  Row lanes
    4q..4q+3 hold plane q as (a_x, a_y, c, 0): q = 0..2 the sign-folded
    edges, q = 3 the depth, q = 4 + d attribute d.  The depth and
    attribute planes precombine the per-edge weights w_i:
    a_x = (A0' w0 + A1' w1) + A2' w2, and the same for a_y and c — three
    terms in a fixed order where JAX's ``jnp.sum`` leaves the order to
    XLA."""
    sg = sign[..., None]
    As, Bs, Cs = A * sg, B * sg, C * sg
    w_z = zplane_scaled * sg                                # (..., F, 3)
    attrs_sc = attrs * (inv_area * sign)[..., None, None]   # (..., F, 3, D)
    zero = torch.zeros_like(As[..., 0])

    def comb(e, w):
        return (e[..., 0] * w[..., 0] + e[..., 1] * w[..., 1]
                + e[..., 2] * w[..., 2])

    cols = []
    for q in range(3):
        cols += [As[..., q], Bs[..., q], Cs[..., q], zero]
    for w in [w_z] + [attrs_sc[..., d] for d in range(D)]:
        cols += [comb(As, w), comb(Bs, w), comb(Cs, w), zero]
    table = torch.stack(cols, dim=-1)
    table = torch.where(valid[..., None], table, float("nan")).to(
        torch.float32)
    return torch.cat([table, table.new_full(
        table.shape[:-2] + (1, ROW_W), float("nan"))], dim=-2)


def bf16_round(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32: the
    operand rounding of one bf16 pass of the matrix unit (``mxu=2``)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split3(a, mxu: int):
    """a = p0 + p1 + p2 in bfloat16 parts (8 significant bits each cover
    float32's 24; exact away from underflow), each part float32; ``mxu=2``
    keeps p0 alone, and a non-finite p0 keeps zero parts (a NaN row stays
    NaN).  The MMA walk's ``split3``."""
    p0 = bf16_round(a)
    zero = torch.zeros_like(a)
    if mxu != 1:
        return [p0, zero, zero]
    fin = torch.isfinite(p0)
    r = a - p0
    p1 = bf16_round(r)
    p2 = bf16_round(r - p1)
    return [p0, torch.where(fin, p1, zero), torch.where(fin, p2, zero)]


def mma_operands(rows, x, y, mxu: int):
    """The MMA walk's operands (``csrc/tile_raster.cu``: ``a_frag``,
    ``build_b``) for the affine rows ``rows`` (T, ROW_W) of
    :func:`build_table_mxu` at the pixels ``x``, ``y`` (P,) float32:
    (A (P, 16), B (16, 64 n) with n = ceil(T / 16), cols (64 n, 2)), all
    float32 but ``cols``, every value of A and B a bfloat16.

    K is xh xl xh xl xh xl | yh yl yh yl yh yl | 1 1 1 | 0 in A against
    ax0 ax0 ax1 ax1 ax2 ax2 | ay0 ay0 ay1 ay1 ay2 ay2 | c0 c1 c2 | 0 in B,
    x = xh + xl and a = a0 + a1 + a2 exact bf16 parts (``mxu=2``: xl, a1,
    a2 are 0, one bf16 pass), so A @ B in float64 is each plane
    (a_x x + a_y y) + c exactly.  B is n operands of 16 triangles (one
    wgmma m64n64k16 each): its column 64 s + 8 i + c is plane
    2 (i % 2) + c % 2 of triangle 16 s + 4 (i // 2) + c // 2 (``cols``:
    (triangle, plane) of each column), so the lane of a quad that holds
    columns 8 i + 2 q, + 1 holds the four walk planes of triangles 4 k +
    q.  Triangles T .. 16 n - 1 are NaN columns, which never cover."""
    T = rows.shape[0]
    n = -(-T // 16)
    pad = rows.new_full((16 * n - T, ROW_W), float("nan"))
    rows = torch.cat([rows.to(torch.float32), pad])
    live = torch.arange(16 * n, device=rows.device) < T
    # B's 16 K rows of every (triangle, plane)
    ks = []
    for pl in range(4):
        ax, ay, c = (_split3(rows[:, 4 * pl + m], mxu) for m in range(3))
        col = [ax[0], ax[0], ax[1], ax[1], ax[2], ax[2],
               ay[0], ay[0], ay[1], ay[1], ay[2], ay[2], c[0], c[1], c[2],
               torch.zeros_like(c[0])]
        col = torch.stack(col)                            # (16, 16 n)
        dead = torch.zeros_like(col)
        dead[:2] = float("nan")                           # ax0 ax0
        ks.append(torch.where(live, col, dead))
    t = torch.arange(16 * n, device=rows.device)
    B = rows.new_empty((16, 64 * n))
    cols = torch.empty((64 * n, 2), dtype=torch.long, device=rows.device)
    for pl in range(4):
        tt = t % 16
        i = 2 * (tt // 4) + pl // 2
        c = 2 * (tt % 4) + pl % 2
        idx = 64 * (t // 16) + 8 * i + c
        B[:, idx] = ks[pl]
        cols[idx, 0] = t
        cols[idx, 1] = pl
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xh, yh = bf16_round(x), bf16_round(y)
    xl = x - xh if mxu == 1 else torch.zeros_like(x)
    yl = y - yh if mxu == 1 else torch.zeros_like(y)
    one = torch.ones_like(x)
    A = torch.stack([xh, xl, xh, xl, xh, xl, yh, yl, yh, yl, yh, yl,
                     one, one, one, torch.zeros_like(x)], dim=1)
    return A, B, cols


def warp_boxes(tile_w: int, tile_h: int):
    """K5's pixel layout (``csrc/tile_raster.cu``, the split walk with
    ``BOX``) at tiles :data:`BOX_TILE_W` wide: (boxes (WARPS, 4) int64
    [x0, x1, y0, y1], each warp's box of pixel coordinates in a tile at
    the origin, bounds included; warp (P,) int64, the warp that owns each
    pixel slot).  Warp w owns the strip of BOX_W columns from BOX_W w,
    all rows (16x16 at 128x16).  At other widths the kernel keeps the
    row-major layout and culls nothing: None."""
    if tile_w != BOX_TILE_W:
        return None
    p = torch.arange(tile_w * tile_h)
    w = torch.arange(WARPS)
    boxes = torch.stack([w * BOX_W, w * BOX_W + BOX_W - 1,
                         torch.zeros_like(w),
                         torch.full_like(w, tile_h - 1)], dim=1)
    return boxes, p % tile_w // BOX_W


def cull_keep(rows, box):
    """The plain version of K5's cull (``box_culled`` in
    ``csrc/tile_raster.cu``): False where the triangle of an edge row
    cannot cover any pixel of the box as the walk evaluates its edges,
    in the kernel's expression and order.  rows (..., ROW_W) float32 and
    box (..., 4) float32 [x0, x1, y0, y1] (pixel coordinates, bounds
    included) broadcast together.  A row is culled when for some edge i
    the walk's own value (A x + B y) + C, each operation rounded, is
    negative at the box's pixel (x1 if A > 0 else x0, y1 if B > 0 else
    y0).  Rounding to nearest is monotone, so that rounded value is the
    largest the walk computes at any pixel of the box: the edge is
    negative at every one of them, exactly as the walk evaluates it.  A
    NaN coefficient culls by no edge it is in (the row never covers)."""
    x0, x1, y0, y1 = box.unbind(-1)
    culled = torch.zeros(torch.broadcast_shapes(rows.shape[:-1],
                                                box.shape[:-1]),
                         dtype=torch.bool, device=rows.device)
    for i in range(3):
        a, b, c = (rows[..., 3 * i + k] for k in range(3))
        x = torch.where(a > 0.0, x1, x0)
        y = torch.where(b > 0.0, y1, y0)
        culled |= a * x + b * y + c < 0.0
    return ~culled


def _runs_cull_keep(n_walk, L: int, rows_at, nt: int, width: int,
                    tile_w: int, tile_h: int):
    """(NB, L, WARPS) bool: True where warp w of tile b walks run slot j
    (j < n_walk[b] and, at tiles :data:`BOX_TILE_W` wide, :func:`cull_keep`
    keeps the row for the warp's box); ``rows_at(tiles, slots)`` the rows
    of those slots of those tiles, as :func:`_walk` takes them."""
    nb, dev = n_walk.shape[0], n_walk.device
    ntx = (width + tile_w - 1) // tile_w
    walked = torch.arange(L, device=dev)[None, :] < n_walk[:, None]
    layout = warp_boxes(tile_w, tile_h)
    if layout is None:
        return walked[..., None].expand(nb, L, WARPS).clone()
    t = torch.arange(nb, device=dev) % nt
    org = torch.stack([t % ntx * tile_w, t % ntx * tile_w,
                       t // ntx * tile_h, t // ntx * tile_h], dim=1)
    box = (org[:, None, :] + layout[0].to(dev)).to(torch.float32)
    keep = torch.zeros((nb, L, WARPS), dtype=torch.bool, device=dev)
    for j0 in range(0, L, 64):
        act = torch.nonzero(n_walk > j0).squeeze(1)
        j = torch.arange(j0, min(j0 + 64, L), device=dev)
        rows = rows_at(act, j.expand(act.shape[0], -1))
        k = cull_keep(rows[:, :, None, :], box[act][:, None, :, :])
        keep[act[:, None], j[None, :]] = k & walked[act][:, j, None]
    return keep


def bins_cull_keep(bins, counts, table, width: int, tile_w: int,
                   tile_h: int):
    """K5's cull over its bins: (NB, K, WARPS) bool, True where warp w of
    tile b walks bin slot j (j < min(counts[b], K) and, at tiles
    :data:`BOX_TILE_W` wide, :func:`cull_keep` keeps the row for the
    warp's box); inputs as :func:`raster_tiles_bins_f32`.  Its sum is the
    (row, warp) pairs the kernel walks, P / WARPS pixels each."""
    nt, K, nrows = counts.shape[-1], bins.shape[-1], table.shape[-2]
    bn = bins.reshape(-1, K)
    tb = table.reshape(-1, ROW_W)

    def rows_at(tiles, slots):
        f = _frame_of(tiles, nt, slots)
        tri = bn[tiles.reshape(f.shape), slots]
        return tb[f * nrows + tri.clamp(0, nrows - 1)]

    return _runs_cull_keep(counts.reshape(-1).clamp(max=K), K, rows_at, nt,
                           width, tile_w, tile_h)


def pairs_cull_keep(sorted_pad, starts, counts, table, width: int,
                    tile_w: int, tile_h: int):
    """K2a's cull over its runs of sorted pairs, the twin of
    :func:`bins_cull_keep`: (NB, L, WARPS) bool with L the longest run
    (at least 1), True where warp w of tile b walks run slot j
    (j < counts[b] and, at tiles :data:`BOX_TILE_W` wide, :func:`cull_keep`
    keeps the row for the warp's box); inputs as
    :func:`raster_tiles_keys_f32`, one frame or B frames.  Its sum is the
    (row, warp) pairs the kernel walks, P / WARPS pixels each."""
    n_walk = counts.reshape(-1).clamp(min=0)
    L = max(1, int(n_walk.max()) if n_walk.numel() else 1)
    return _runs_cull_keep(n_walk, L, _pairs_rows_at(sorted_pad, starts,
                                                     counts, table),
                           counts.shape[-1], width, tile_w, tile_h)


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
    """(..., NT, P) packed int32 -> (..., NT, P, 4) uint8 (little-endian:
    r first)."""
    return packed.view(torch.uint8).reshape(*packed.shape, 4)


def _detile_frames(planes, width: int, height: int, tile_w: int,
                   tile_h: int):
    """(B, NT, P, *rest) per-tile planes of B frames -> (B, H, W, *rest)
    raster order, cropping padded slots."""
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    n, rest = planes.shape[0], planes.shape[3:]
    p2 = planes.reshape(n, nty, ntx, tile_h, tile_w, *rest).transpose(2, 3)
    return p2.reshape(n, nty * tile_h, ntx * tile_w,
                      *rest)[:, :height, :width]


def _detile_plane(plane, width: int, height: int, tile_w: int,
                  tile_h: int):
    """(NT, P, *rest) per-tile planes -> (H, W, *rest) raster order,
    cropping padded slots (``pallas_raster.py:939-943``)."""
    return _detile_frames(plane[None], width, height, tile_w, tile_h)[0]


def detile_packed(packed, width: int, height: int, tile_w: int,
                  tile_h: int):
    """(NT, P) packed int32 tiles -> (H, W, 4) uint8 raster order,
    cropping padded slots (``pallas_raster.py:946-950``); (B, NT, P) ->
    (B, H, W, 4)."""
    one = packed.dim() == 2
    p2 = _detile_frames(packed[None] if one else packed, width, height,
                        tile_w, tile_h)
    u8 = p2.contiguous().view(torch.uint8).reshape(*p2.shape, 4)
    return u8[0] if one else u8


def detile_keys_rgba(keys, rgba, width: int, height: int, tile_w: int,
                     tile_h: int, bg, dtype):
    """K2a's or K5's (NT, P) keys and (NT, D, P) rgba -> (keys (H, W)
    int32, rgba (H, W, D) in ``dtype``), bg cast to ``dtype`` where the
    key is SKY_KEY (``pallas_raster._detile``, ``:1508-1523``); with a
    leading B on both, (B, H, W) and (B, H, W, D)."""
    one = keys.dim() == 2
    if one:
        keys, rgba = keys[None], rgba[None]
    keys2d = _detile_frames(keys, width, height, tile_w, tile_h)
    rgba2d = _detile_frames(rgba.transpose(2, 3), width, height, tile_w,
                            tile_h)
    bgv = torch.as_tensor(bg, dtype=dtype, device=rgba.device)
    sky = (keys2d == SKY_KEY)[..., None]
    out = keys2d, torch.where(sky, bgv, rgba2d.to(dtype))
    return tuple(a[0] for a in out) if one else out


def _check_tensors(dev, **named):
    """Each named (tensor, dtype) pair, None tensors skipped: of that
    dtype, on ``dev``, contiguous."""
    for name, (t, dtype) in named.items():
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_tile(tile_w: int, tile_h: int):
    if not 0 < tile_w * tile_h <= MAX_P:
        raise ValueError(f"tile {tile_w}x{tile_h} must hold 1..{MAX_P} "
                         f"pixels")


def _check_runs(ids, starts, counts, rows, ids_name, rows_name):
    """One frame: ids (S,), starts and counts (NT,), rows (N, ROW_W); or
    B frames, each with a leading B (None tensors skipped)."""
    lead = tuple(counts.shape[:-1])
    if counts.dim() not in (1, 2):
        raise ValueError(f"counts must be (NT,) or (B, NT), got "
                         f"{tuple(counts.shape)}")
    if starts is not None and starts.shape != counts.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and counts "
                         f"{tuple(counts.shape)} must be the same shape")
    if ids is not None and (ids.dim() != len(lead) + 1
                            or tuple(ids.shape[:-1]) != lead
                            or ids.shape[-1] == 0):
        raise ValueError(f"{ids_name} must be a non-empty (S,) or (B, S) "
                         f"array matching counts {tuple(counts.shape)}, "
                         f"got {tuple(ids.shape)}")
    if (rows.dim() != len(lead) + 2 or tuple(rows.shape[:-2]) != lead
            or rows.shape[-1] != ROW_W or rows.shape[-2] < 1):
        raise ValueError(f"{rows_name} must be (N, {ROW_W}) or "
                         f"(B, N, {ROW_W}) matching counts "
                         f"{tuple(counts.shape)}, got {tuple(rows.shape)}")


def _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h,
                  packed_bg=None, tex_packed=None, tex_dims=None):
    """The pair walk's inputs (one frame or B frames) and an epilogue's."""
    _check_tensors(table.device, sorted_pad=(sorted_pad, torch.int32),
                   starts=(starts, torch.int32),
                   counts=(counts, torch.int32),
                   table=(table, torch.float32),
                   packed_bg=(packed_bg, torch.int32),
                   tex_packed=(tex_packed, torch.int32))
    _check_runs(sorted_pad, starts, counts, table, "sorted_pad", "table")
    if packed_bg is not None and packed_bg.shape != (1,):
        raise ValueError(f"packed_bg must be (1,), got "
                         f"{tuple(packed_bg.shape)}")
    _check_tile(tile_w, tile_h)
    if tex_dims is not None:
        th, tw = tex_dims
        if th < 1 or tw < 1:
            raise ValueError(f"texture dims {tex_dims} must be positive")
        if tex_packed is not None and tex_packed.shape != (th * tw,):
            raise ValueError(f"tex_packed must be ({th} * {tw},), got "
                             f"{tuple(tex_packed.shape)}")


def _check_tex_tile(tile_w: int, tile_h: int) -> int:
    """The textured launcher's tile rule; returns P."""
    P = tile_w * tile_h
    if P % 128 or P < 256:
        raise ValueError(f"textured tiles need P % 128 == 0 and P >= 256, "
                         f"got {tile_w}x{tile_h} (the JAX launcher's "
                         f"Mosaic lane constraint, kept for parity)")
    return P


def _split_scratch(sorted_pad, counts, table, bins=False):
    """The split walk's launch arguments (K1, K3, K2b, K2a, K5, K6): the item
    list (int2 a slot) sized for runs that partition each frame's pairs,
    B * nt + B * ids_len // SEG items; with ``sorted_pad`` None (K6, whose
    runs index ``table``, the CAP rows a frame gathered in pair order)
    B * nt + B * CAP // SEG; or with ``bins`` (``sorted_pad`` the bins,
    K = ids_len slots a tile) B * nt * ceil(K / SEG), every run's items;
    its size and the counters (3 + B * nt ints), in one uninitialised
    allocation (the kernel's plan fills it).  Runs that do not partition
    them (a flagged frame) may not fit: the plan then walks every tile as
    one item, with the same values."""
    if table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (its rows are "
                         "copied 16 bytes at a time)")
    nb = counts.numel()
    if bins:
        cap = nb * -(-sorted_pad.shape[-1] // SEG)
    else:
        span = (table.shape[-2] if sorted_pad is None
                else sorted_pad.shape[-1])
        cap = nb + (nb // counts.shape[-1]) * span // SEG
    scratch = torch.empty(2 * cap + 3 + nb, dtype=torch.int32,
                          device=table.device)
    return scratch, cap, scratch.data_ptr() + 8 * cap


def _launch_u8(sorted_pad, starts, counts, table, packed_bg, width,
               tile_w, tile_h, opaque, z_clip, *, mxu: int, wf: int):
    """K1's split walk (the C entry ``tile_raster_u8``) into a new
    (..., NT, P) output: the FMA walk (``mxu=0``) or the MMA walk, ``wf``
    items a claim."""
    out = torch.empty(counts.shape + (tile_w * tile_h,), dtype=torch.int32,
                      device=table.device)
    _launch("tile_raster_u8", sorted_pad, starts, counts, counts.shape[-1],
            table, width, tile_w, tile_h, z_clip, packed_bg, int(opaque),
            mxu, wf, out, *_split_scratch(sorted_pad, counts, table))
    return out


def _launch_tex_u8(sorted_pad, starts, counts, table, tex_packed, tex_dims,
                   packed_bg, width, tile_w, tile_h, z_clip, *, mxu: int):
    """K3's split walk (the C entry ``tile_raster_tex_u8``) into a new
    (..., NT, P) output: the FMA walk (``mxu=0``) or the MMA walk."""
    th, tw = tex_dims
    out = torch.empty(counts.shape + (tile_w * tile_h,), dtype=torch.int32,
                      device=table.device)
    _launch("tile_raster_tex_u8", sorted_pad, starts, counts,
            counts.shape[-1], table, width, tile_w, tile_h, z_clip,
            tex_packed, tw, th, packed_bg, mxu, out,
            *_split_scratch(sorted_pad, counts, table))
    return out


def _on_cpu(table, kernel: str) -> bool:
    """True for CPU tensors (run the plain version), False for CUDA ones
    (launch the kernel); raises for any other device."""
    if table.device.type == "cpu":
        return True
    if table.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {table.device}")
    return False


def _launch(entry: str, ids, starts, counts, nt: int, table, width: int,
            tile_w: int, tile_h: int, z_clip: bool, *epilogue) -> None:
    """Launch ``entry`` of csrc/tile_raster.cu on the current stream over
    ``counts.numel()`` tiles, ``nt`` a frame: the walk's arguments (ids
    or starts may be None), then the epilogue's (ints and tensors)."""
    from . import _kernels
    dev = table.device
    ntx = (width + tile_w - 1) // tile_w
    epi = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
           for a in epilogue]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _kernels.launch_tile_raster(
            entry, 0 if ids is None else ids.data_ptr(),
            0 if ids is None else ids.shape[-1],
            0 if starts is None else starts.data_ptr(), counts.data_ptr(),
            counts.numel(), nt, table.data_ptr(), table.shape[-2], ntx,
            tile_w, tile_h, int(z_clip), *epi, stream)


def raster_tiles_flat_u8(sorted_pad, starts, counts, table, packed_bg,
                         width: int, tile_w: int, tile_h: int, *,
                         opaque: bool, z_clip: bool):
    """Kernel K1: one packed u8 RGBA int32 per pixel of every tile,
    (NT, P) with P = tile_w * tile_h.  Counterpart of
    ``render_binned_pallas_flat_u8`` (``pallas_raster.py:953-1007``) up to
    the detile, taking ``starts``/``counts`` directly (no TPU block
    windows).  B frames at once (sorted_pad (B, Spad), starts and counts
    (B, NT), table (B, F + 1, ROW_W)) give (B, NT, P) in one launch.

    For tile t and slot p at pixel (ox + p % tile_w, oy + p // tile_w),
    walk the run ``sorted_pad[starts[t] : starts[t] + counts[t]]`` in
    order; for each triangle row evaluate e_i = (A_i x + B_i y) + C_i,
    cover when all e_i >= 0 (and 0 <= z <= 1 with ``z_clip``), key =
    (int(z * Z_LEVELS) << IDX_BITS) | slot, keep the strict minimum (the
    lower slot wins a tie).  The winner's RGBA is
    (e0 a0 + e1 a1) + e2 a2 per channel, packed after clip(v * 255, 0,
    255) truncation, alpha 255 with ``opaque``; tiles' slots no triangle
    covers get ``packed_bg[0]``.

    CUDA tensors launch the kernel on the current stream (no sync): the
    split walk, a run cut into items of at most :data:`SEG` slots whose
    keys merge exactly (a plan kernel, then the walk: one call, counted
    once in ``launches``).  CPU tensors run
    :func:`raster_tiles_flat_u8_reference`."""
    _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h,
                  packed_bg=packed_bg)
    if _on_cpu(table, "K1"):
        return raster_tiles_flat_u8_reference(
            sorted_pad, starts, counts, table, packed_bg, width, tile_w,
            tile_h, opaque=opaque, z_clip=z_clip)
    out = _launch_u8(sorted_pad, starts, counts, table, packed_bg, width,
                     tile_w, tile_h, opaque, z_clip, mxu=0, wf=1)
    raster_tiles_flat_u8.launches += 1
    return out


raster_tiles_flat_u8.launches = 0


def raster_tiles_tex_u8(sorted_pad, starts, counts, table, tex_packed,
                        tex_dims, packed_bg, width: int, tile_w: int,
                        tile_h: int, *, z_clip: bool):
    """Kernel K3: K1's walk over a textured table, each pixel the packed
    u8 texel ``tex_packed[vi * tw + ui]`` of the winner's clamped-nearest
    texel (see :func:`raster_tiles_tex_idx`), ``packed_bg[0]`` where no
    triangle covers it; (NT, P) int32.  ``tex_packed`` is
    :func:`raster3d.pack_texture_u8` of a (th, tw, 4) texture,
    ``tex_dims`` = (th, tw).

    Counterpart of ``raster_tiles_tex`` (``pallas_raster.py:821-906``)
    followed by ``raster3d._tex_resolve_finish``: the TPU kernel fetches
    texels through per-tile footprint windows and leaves the pixels they
    miss to an XLA gather; both fetch the same texel, which this kernel
    loads directly.  Like the JAX launcher it takes only tiles of
    P % 128 == 0 and P >= 256 pixels.

    CUDA tensors launch the kernel on the current stream (no sync), K1's
    split walk (see :func:`raster_tiles_flat_u8`); CPU tensors run
    :func:`raster_tiles_tex_u8_reference`."""
    _check_tex_tile(tile_w, tile_h)
    _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h,
                  packed_bg=packed_bg, tex_packed=tex_packed,
                  tex_dims=tex_dims)
    if _on_cpu(table, "K3"):
        return raster_tiles_tex_u8_reference(
            sorted_pad, starts, counts, table, tex_packed, tex_dims,
            packed_bg, width, tile_w, tile_h, z_clip=z_clip)
    out = _launch_tex_u8(sorted_pad, starts, counts, table, tex_packed,
                         tex_dims, packed_bg, width, tile_w, tile_h, z_clip,
                         mxu=0)
    raster_tiles_tex_u8.launches += 1
    return out


raster_tiles_tex_u8.launches = 0


def raster_tiles_tex_idx(sorted_pad, starts, counts, table, tex_dims,
                         width: int, tile_w: int, tile_h: int, *,
                         z_clip: bool):
    """Kernel K2b: K1's walk over a textured table, each pixel the index
    vi * tw + ui of the winner's clamped-nearest texel, -1 where no
    triangle covers it; (NT, P) int32, ``tex_dims`` = (th, tw).  With the
    winner's interpolated attributes r0..r2, safe = r2 if r2 != 0 else 1,
    ui = clip(int(r0 / safe * tw), 0, tw - 1) and vi the same with r1 and
    th, the conversion truncating, saturating and sending NaN to 0
    (``pallas_raster.py:356-374``).  B frames (a leading B on each input)
    give (B, NT, P) in one launch.

    CUDA tensors launch the kernel on the current stream (no sync), K3's
    split walk with the index as its epilogue (see
    :func:`raster_tiles_flat_u8`); CPU tensors run
    :func:`raster_tiles_tex_idx_reference`."""
    _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h,
                  tex_dims=tex_dims)
    if _on_cpu(table, "K2b"):
        return raster_tiles_tex_idx_reference(
            sorted_pad, starts, counts, table, tex_dims, width, tile_w,
            tile_h, z_clip=z_clip)
    th, tw = tex_dims
    out = torch.empty(counts.shape + (tile_w * tile_h,), dtype=torch.int32,
                      device=table.device)
    _launch("tile_raster_tex_idx", sorted_pad, starts, counts,
            counts.shape[-1], table, width, tile_w, tile_h, z_clip, tw, th,
            out, *_split_scratch(sorted_pad, counts, table))
    raster_tiles_tex_idx.launches += 1
    return out


raster_tiles_tex_idx.launches = 0


def raster_tiles_keys_f32(sorted_pad, starts, counts, table, width: int,
                          tile_w: int, tile_h: int, *, z_clip: bool):
    """Kernel K2a: K1's walk with float32 outputs, (keys (NT, P) int32,
    rgba (NT, D, P) float32).  A key is the winner's
    (int(z * Z_LEVELS) << IDX_BITS) | run slot, SKY_KEY where no triangle
    covers the pixel; channel d is (e0 a0d + e1 a1d) + e2 a2d of the
    winner, 0 for sky (the JAX accumulators start at zero and a chunk
    without cover leaves them, ``pallas_raster.py:597-599``).  B frames
    (a leading B on each input) give (B, NT, P) and (B, NT, D, P) in one
    launch.

    CUDA tensors launch the kernel on the current stream (no sync): K1's
    split walk (see :func:`raster_tiles_flat_u8`) with K5's epilogue, and
    at tiles :data:`BOX_TILE_W` wide (each of its entries' defaults) K5's
    warp boxes and cull (:func:`raster_tiles_bins_f32`,
    :func:`pairs_cull_keep`), which change no value; one call, counted
    once in ``launches``.  CPU tensors run
    :func:`raster_tiles_keys_f32_reference`."""
    _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h)
    if _on_cpu(table, "K2a"):
        return raster_tiles_keys_f32_reference(
            sorted_pad, starts, counts, table, width, tile_w, tile_h,
            z_clip=z_clip)
    keys, rgba = _keys_rgba_out(counts, tile_w * tile_h, table.device)
    _launch("tile_raster_keys_f32", sorted_pad, starts, counts,
            counts.shape[-1], table, width, tile_w, tile_h, z_clip, keys,
            rgba, *_split_scratch(sorted_pad, counts, table))
    raster_tiles_keys_f32.launches += 1
    return keys, rgba


raster_tiles_keys_f32.launches = 0


def _keys_rgba_out(counts, P: int, dev):
    return (torch.empty(counts.shape + (P,), dtype=torch.int32, device=dev),
            torch.empty(counts.shape + (D, P), dtype=torch.float32,
                        device=dev))


def raster_tiles_bins_f32(bins, counts, table, width: int, tile_w: int,
                          tile_h: int):
    """Kernel K5: K2a's outputs (keys (NT, P) int32, rgba (NT, D, P)
    float32) with each tile's rows named by its bins row — counterpart of
    ``raster_tiles`` (``pallas_raster.py:1396-1442``).

    bins (NT, K) int32 triangle ids, NO_TRI slots already remapped to the
    table's NaN pad row; counts (NT,) int32; table (F + 1, ROW_W).  Tile t
    walks its slots j < min(counts[t], K) with the z test on: a run longer
    than K (a tile the binning flagged) walks its K slots and reads
    nothing past them.  A key's low IDX_BITS are the BIN SLOT j, as in
    the JAX kernel.  B frames at once (bins (B, NT, K), counts (B, NT),
    table (B, F + 1, ROW_W)) give (B, NT, P) and (B, NT, D, P) in one
    launch.

    CUDA tensors launch the kernel on the current stream (no sync): K1's
    split walk over the bins (every run cut into items of at most
    :data:`SEG` slots, merged exactly by key); at tiles
    :data:`BOX_TILE_W` wide (the entries' defaults) each warp walks only
    the rows whose triangle may cover a pixel of its box
    (:func:`warp_boxes`, :func:`cull_keep`), which changes no value; one
    call, counted once in ``launches``.  CPU tensors run
    :func:`raster_tiles_bins_f32_reference`."""
    _check_tensors(table.device, bins=(bins, torch.int32),
                   counts=(counts, torch.int32),
                   table=(table, torch.float32))
    if bins.shape[:-1] != counts.shape or bins.shape[-1] == 0:
        raise ValueError(f"bins must be counts' shape {tuple(counts.shape)} "
                         f"plus K > 0 slots, got {tuple(bins.shape)}")
    _check_runs(None, None, counts, table, "bins", "table")
    _check_tile(tile_w, tile_h)
    if _on_cpu(table, "K5"):
        return raster_tiles_bins_f32_reference(bins, counts, table, width,
                                               tile_w, tile_h)
    keys, rgba = _keys_rgba_out(counts, tile_w * tile_h, table.device)
    _launch("tile_raster_bins_f32", bins, None, counts, counts.shape[-1],
            table, width, tile_w, tile_h, True, keys, rgba,
            *_split_scratch(bins, counts, table, bins=True))
    raster_tiles_bins_f32.launches += 1
    return keys, rgba


raster_tiles_bins_f32.launches = 0


def raster_tiles_rows_u8(rows, starts, counts, packed_bg, width: int,
                         tile_w: int, tile_h: int):
    """Kernel K6: K1's opaque packed u8 values, without the z test, for
    B frames, (B, NT, P) int32 — counterpart of ``raster_tiles_dynrows``
    (``pallas_raster.py:1271-1299``).

    rows (B, CAP, ROW_W) float32 are each frame's table rows gathered in
    pair order, ``table[sorted_pad[:CAP] & IDX_MASK]``; starts and counts
    (B, NT) int32.  Tile t of frame b walks rows[b, starts[b, t] + j] for
    j < counts[b, t], reads clamped below CAP (a run past CAP is flagged
    by the caller).  The same rows in the same order as K1's walk over
    the pair array, so the same bits as K1 (opaque, z_clip off).  The TPU
    kernel's g frames a program and 24 MiB operand groups were its grid
    and compile limits: one launch covers the batch.

    CUDA tensors launch the kernel on the current stream (no sync): K1's
    split walk over the rows (see :func:`raster_tiles_flat_u8`), its item
    list sized from CAP; CPU tensors run
    :func:`raster_tiles_rows_u8_reference`."""
    _check_tensors(rows.device, rows=(rows, torch.float32),
                   starts=(starts, torch.int32),
                   counts=(counts, torch.int32),
                   packed_bg=(packed_bg, torch.int32))
    if counts.dim() != 2:
        raise ValueError(f"rows, starts and counts must carry a batch: "
                         f"(B, CAP, {ROW_W}), (B, NT), (B, NT)")
    _check_runs(None, starts, counts, rows, "", "rows")
    if packed_bg.shape != (1,):
        raise ValueError(f"packed_bg must be (1,), got "
                         f"{tuple(packed_bg.shape)}")
    _check_tile(tile_w, tile_h)
    if _on_cpu(rows, "K6"):
        return raster_tiles_rows_u8_reference(rows, starts, counts,
                                              packed_bg, width, tile_w,
                                              tile_h)
    out = torch.empty(counts.shape + (tile_w * tile_h,), dtype=torch.int32,
                      device=rows.device)
    _launch("tile_raster_rows_u8", None, starts, counts, counts.shape[-1],
            rows, width, tile_w, tile_h, False, packed_bg, 1, out,
            *_split_scratch(None, counts, rows))
    raster_tiles_rows_u8.launches += 1
    return out


raster_tiles_rows_u8.launches = 0


def _check_mxu(mxu: int) -> int:
    if mxu not in (1, 2):
        raise ValueError(f"mxu must be 1 (near float32) or 2 (one bfloat16 "
                         f"pass), got {mxu}")
    return mxu


def raster_tiles_flat_u8_wf(sorted_pad, starts, counts, table, packed_bg,
                            width: int, tile_w: int, tile_h: int, *,
                            opaque: bool, z_clip: bool, wf: int,
                            mxu: int = 0):
    """Kernel K1-wf: K1's output, (NT, P) packed u8 RGBA int32 (B frames:
    (B, NT, P)), from a persistent launch — counterpart of the ``wf``
    branch of ``raster_tiles_flat`` (``pallas_raster.py:713-748``, kernel
    ``kernel_wf`` ``:624-655``).  The TPU programs each walked ``wf``
    consecutive tiles and copied their id blocks into SMEM themselves;
    here K1's split walk (:func:`raster_tiles_flat_u8`, ``wf`` = 1)
    claims ``wf`` consecutive items of its plan at a time and walks them
    in list order, so the values are K1's for every ``wf`` >= 1 (the
    merge is exact in any order).  With ``mxu`` (an affine table) the
    walk is the matrix-unit walk's (:func:`raster_tiles_flat_u8_mxu`), as
    JAX's wf branch takes its ``mxu``.

    CUDA tensors launch the kernel on the current stream (no sync);
    CPU tensors run K1's plain version (with ``mxu``, K1-mxu's)."""
    if wf < 1:
        raise ValueError(f"wf must be >= 1, got {wf}")
    if mxu:
        _check_mxu(mxu)
    _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h,
                  packed_bg=packed_bg)
    if _on_cpu(table, "K1-wf"):
        if mxu:
            return raster_tiles_flat_u8_mxu_reference(
                sorted_pad, starts, counts, table, packed_bg, width, tile_w,
                tile_h, opaque=opaque, z_clip=z_clip, mxu=mxu)
        return raster_tiles_flat_u8_reference(
            sorted_pad, starts, counts, table, packed_bg, width, tile_w,
            tile_h, opaque=opaque, z_clip=z_clip)
    out = _launch_u8(sorted_pad, starts, counts, table, packed_bg, width,
                     tile_w, tile_h, opaque, z_clip, mxu=mxu, wf=wf)
    raster_tiles_flat_u8_wf.launches += 1
    return out


raster_tiles_flat_u8_wf.launches = 0


def raster_tiles_flat_u8_mxu(sorted_pad, starts, counts, table, packed_bg,
                             width: int, tile_w: int, tile_h: int, *,
                             opaque: bool, z_clip: bool, mxu: int):
    """Kernel K1-mxu: K1's u8 output from the matrix-unit walk over an
    affine table (:func:`build_table_mxu`) — counterpart of the ``mxu``
    branch of ``_make_kernel_flat`` (``pallas_raster.py:242-250,285-301,
    326-327``) in the u8 launch (``:793``).  K1's split walk with the
    walk's 4 planes (edges, depth) of 16 triangles at 64 pixels as one
    bf16 tensor-core product (``wgmma``) with float32 accumulation
    (operands: :func:`mma_operands`): ``mxu=1`` splits coordinates and
    coefficients into exact bf16 parts (near float32, the TPU's HIGHEST),
    ``mxu=2`` takes one bf16 pass (the TPU's DEFAULT, which rounds the
    pixel coordinates themselves: a measurement setting).  Coverage, key
    and minimum are K1's; the channels are the winner's planes 4 + d,
    evaluated on the CUDA cores in the plain version's rounding, so they
    are its bits wherever the winner agrees.  B frames (a leading B) in
    one launch.

    CUDA tensors launch the kernel on the current stream (no sync); CPU
    tensors run :func:`raster_tiles_flat_u8_mxu_reference`, which the
    kernel matches within a tolerance (the tensor cores' accumulation is
    not IEEE round-to-nearest)."""
    _check_mxu(mxu)
    _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h,
                  packed_bg=packed_bg)
    if _on_cpu(table, "K1-mxu"):
        return raster_tiles_flat_u8_mxu_reference(
            sorted_pad, starts, counts, table, packed_bg, width, tile_w,
            tile_h, opaque=opaque, z_clip=z_clip, mxu=mxu)
    out = _launch_u8(sorted_pad, starts, counts, table, packed_bg, width,
                     tile_w, tile_h, opaque, z_clip, mxu=mxu, wf=1)
    raster_tiles_flat_u8_mxu.launches += 1
    return out


raster_tiles_flat_u8_mxu.launches = 0


def raster_tiles_tex_u8_mxu(sorted_pad, starts, counts, table, tex_packed,
                            tex_dims, packed_bg, width: int, tile_w: int,
                            tile_h: int, *, z_clip: bool, mxu: int):
    """K3 over the matrix-unit walk: the packed texel of the winner's
    clamped-nearest texel, its (u, v, 1/w) the winner's planes 4..6 of an
    affine textured table — counterpart of ``raster_tiles_tex`` with
    ``mxu`` (``pallas_raster.py:895``).  Inputs and the tile rule as
    :func:`raster_tiles_tex_u8`, the walk as
    :func:`raster_tiles_flat_u8_mxu`.

    CUDA tensors launch the kernel on the current stream (no sync); CPU
    tensors run :func:`raster_tiles_tex_u8_mxu_reference`."""
    _check_mxu(mxu)
    _check_tex_tile(tile_w, tile_h)
    _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h,
                  packed_bg=packed_bg, tex_packed=tex_packed,
                  tex_dims=tex_dims)
    if _on_cpu(table, "K3-mxu"):
        return raster_tiles_tex_u8_mxu_reference(
            sorted_pad, starts, counts, table, tex_packed, tex_dims,
            packed_bg, width, tile_w, tile_h, z_clip=z_clip, mxu=mxu)
    out = _launch_tex_u8(sorted_pad, starts, counts, table, tex_packed,
                         tex_dims, packed_bg, width, tile_w, tile_h, z_clip,
                         mxu=mxu)
    raster_tiles_tex_u8_mxu.launches += 1
    return out


raster_tiles_tex_u8_mxu.launches = 0


def _edges(r, X, Y):
    """e_i = (A_i x + B_i y) + C_i of the three sign-folded edges; r[..., k]
    is row column k, broadcast against the pixel coordinates X, Y."""
    return [r[..., 3 * i] * X + r[..., 3 * i + 1] * Y + r[..., 3 * i + 2]
            for i in range(3)]


def _affine(r, X, Y, q: int):
    """Plane q of an affine row (:func:`build_table_mxu`),
    (a_x x + a_y y) + c, each operation rounded on its own."""
    return r[..., 4 * q] * X + r[..., 4 * q + 1] * Y + r[..., 4 * q + 2]


def _walk(n_walk, rows_at, nt: int, width: int, tile_w: int, tile_h: int,
          z_clip: bool, mxu: int = 0):
    """The min-key walk the plain versions share, vectorised over tiles
    and pixels: ``n_walk`` (NB,) slots of each of NB = B * nt tiles (tile
    b is tile b % nt of frame b // nt), ``rows_at(tiles, slots)`` the
    rows (n, ..., ROW_W) of those slots of those tiles — the row source.
    The minimum key over each run is found ``REF_CHUNK`` slots at a time,
    over the tiles whose run reaches the chunk; then the winner's row is
    fetched again and its values recomputed.  Every quantity is the
    kernel's expression in the kernel's order, so the recomputed values
    equal those of the walk.

    With ``mxu`` the rows are affine (:func:`build_table_mxu`): edges,
    depth and attributes are the planes :func:`_affine` of the pixel
    coordinates; ``mxu=2`` rounds the coordinates to bfloat16 first (the
    caller rounds the table).  Returns (best keys (NB, P) int32, attr)
    with ``attr(d)`` the winners' attribute d, (NB, P); a sky pixel's
    attributes are those of slot 0 and mean nothing."""
    nb = n_walk.shape[0]
    P = tile_w * tile_h
    ntx = (width + tile_w - 1) // tile_w
    dev = n_walk.device
    i32 = torch.int32
    b = torch.arange(nb, device=dev)
    t = (b % nt).to(i32)
    p = torch.arange(P, dtype=i32, device=dev)
    X = ((t % ntx * tile_w)[:, None] + p % tile_w).to(torch.float32)
    Y = ((t // ntx * tile_h)[:, None] + p // tile_w).to(torch.float32)
    if mxu == 2:
        X, Y = bf16_round(X), bf16_round(Y)

    def planes(r, x, y):
        """e0, e1, e2 and the depth of rows r at pixels (x, y)."""
        if mxu:
            return [_affine(r, x, y, q) for q in range(4)]
        e0, e1, e2 = _edges(r, x, y)
        return [e0, e1, e2, e0 * r[..., 9] + e1 * r[..., 10] + e2 * r[..., 11]]

    best = torch.full((nb, P), SKY_KEY, dtype=i32, device=dev)
    kmax = int(n_walk.max()) if nb else 0
    for base in range(0, kmax, REF_CHUNK):
        act = torch.nonzero(n_walk > base).squeeze(1)
        j = base + torch.arange(REF_CHUNK, dtype=i32, device=dev)  # (ck,)
        r = rows_at(act, j.expand(act.shape[0], -1))[:, :, None, :]
        e0, e1, e2, zz = planes(r, X[act][:, None, :], Y[act][:, None, :])
        cov = (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
        if z_clip:
            cov = cov & (zz >= 0.0) & (zz <= 1.0)
        cov = cov & (j[None, :] < n_walk[act, None])[..., None]
        keys = ((zz * Z_LEVELS).to(i32) << IDX_BITS) | j[None, :, None]
        keys = torch.where(cov, keys, SKY_KEY)
        best[act] = torch.minimum(best[act], keys.amin(dim=1))

    slot = torch.where(best != SKY_KEY, best & IDX_MASK, 0)
    r = rows_at(b, slot)                                 # (NB, P, 32)
    if mxu:
        return best, lambda d: _affine(r, X, Y, 4 + d)
    e = _edges(r, X, Y)
    return best, lambda d: _channel(r, e, d)


def _frame_of(tiles, nt: int, slots):
    """Each tile's frame, shaped to broadcast against ``slots``."""
    return (tiles // nt).reshape((-1,) + (1,) * (slots.dim() - 1))


def _pairs_rows_at(sorted_pad, starts, counts, table):
    """The rows of run slots of tiles through the sorted pair array, with
    the kernel's clamps (``row_of<PAIRS>``): ``rows_at(tiles, slots)`` as
    :func:`_walk` takes it, one frame or B frames (leading B)."""
    nt = counts.shape[-1]
    spad, nrows = sorted_pad.shape[-1], table.shape[-2]
    sp = sorted_pad.reshape(-1)
    st = starts.reshape(-1)
    tb = table.reshape(-1, ROW_W)

    def rows_at(tiles, slots):
        f = _frame_of(tiles, nt, slots)
        idx = (st[tiles].reshape(f.shape) + slots).clamp(max=spad - 1)
        tri = (sp[f * spad + idx] & IDX_MASK).clamp(max=nrows - 1)
        return tb[f * nrows + tri]

    return rows_at


def _pairs_walk(sorted_pad, starts, counts, table, width, tile_w, tile_h,
                z_clip, mxu=0):
    """:func:`_walk` over the sorted pair array (K1, K3, K2b, K2a and the
    matrix-unit walk), one frame or B frames (leading B); the keys keep
    the leading shape.  ``mxu=2`` rounds the table to bfloat16."""
    rows_at = _pairs_rows_at(sorted_pad, starts, counts,
                             bf16_round(table) if mxu == 2 else table)
    best, attr = _walk(counts.reshape(-1), rows_at, counts.shape[-1], width,
                       tile_w, tile_h, z_clip, mxu)
    return best.reshape(counts.shape + best.shape[1:]), attr


def _channel(r, e, d: int):
    """The winner's attribute d: (e0 a0d + e1 a1d) + e2 a2d
    (``pallas_raster.py:329-330``)."""
    e0, e1, e2 = e
    return (e0 * r[..., 14 + d] + e1 * r[..., 14 + D + d]
            + e2 * r[..., 14 + 2 * D + d])


def _texel_index(attr, tex_dims):
    """vi * tw + ui of the winner's clamped-nearest texel from its
    attributes ``attr(d)`` (K2b's and K3's epilogue,
    ``pallas_raster.py:361-366``).  The divisor is a tensor: CUDA torch
    divides by a Python scalar as a reciprocal multiply."""
    th, tw = tex_dims
    den = attr(2)
    safe = torch.where(den != 0.0, den, 1.0)
    ui = _to_i32(attr(0) / safe * tw).clamp(0, tw - 1)
    vi = _to_i32(attr(1) / safe * th).clamp(0, th - 1)
    return vi * tw + ui


def _u8_epilogue(best, attr, packed_bg, opaque: bool):
    """K1's and K6's packed u8 RGBA of the winners' attributes
    ``attr(d)``, packed bg for sky."""
    q = [_quant_u8(attr(d)) for d in range(3 if opaque else 4)]
    a8 = _ALPHA_255 if opaque else q[3] << 24
    packed = q[0] | (q[1] << 8) | (q[2] << 16) | a8
    return torch.where(best != SKY_KEY, packed.reshape(best.shape),
                       packed_bg)


def _keys_f32_epilogue(best, attr):
    """K2a's and K5's outputs: the keys, and each attribute ``attr(d)``
    of the winner (0 for sky) stacked as (..., D, P)."""
    hit = best != SKY_KEY
    rgba = torch.stack([torch.where(hit, attr(d).reshape(best.shape), 0.0)
                        for d in range(D)], dim=-2)
    return best, rgba


def _tex_idx_epilogue(best, attr, tex_dims):
    """K2b's texel index of the winners, -1 for sky."""
    return torch.where(best != SKY_KEY,
                       _texel_index(attr, tex_dims).reshape(best.shape), -1)


def _tex_u8_epilogue(best, attr, tex_packed, tex_dims, packed_bg):
    """K3's packed texel of the winners, packed bg for sky."""
    texel = tex_packed[_texel_index(attr, tex_dims).long()]
    return torch.where(best != SKY_KEY, texel.reshape(best.shape),
                       packed_bg)


def raster_tiles_flat_u8_reference(sorted_pad, starts, counts, table,
                                   packed_bg, width: int, tile_w: int,
                                   tile_h: int, *, opaque: bool,
                                   z_clip: bool):
    """Plain torch version of K1, same values bit for bit."""
    best, attr = _pairs_walk(sorted_pad, starts, counts, table, width,
                             tile_w, tile_h, z_clip)
    return _u8_epilogue(best, attr, packed_bg, opaque)


def raster_tiles_tex_u8_reference(sorted_pad, starts, counts, table,
                                  tex_packed, tex_dims, packed_bg,
                                  width: int, tile_w: int, tile_h: int, *,
                                  z_clip: bool):
    """Plain torch version of K3, same values bit for bit."""
    best, attr = _pairs_walk(sorted_pad, starts, counts, table, width,
                             tile_w, tile_h, z_clip)
    return _tex_u8_epilogue(best, attr, tex_packed, tex_dims, packed_bg)


def raster_tiles_tex_idx_reference(sorted_pad, starts, counts, table,
                                   tex_dims, width: int, tile_w: int,
                                   tile_h: int, *, z_clip: bool):
    """Plain torch version of K2b, same values bit for bit."""
    best, attr = _pairs_walk(sorted_pad, starts, counts, table, width,
                             tile_w, tile_h, z_clip)
    return _tex_idx_epilogue(best, attr, tex_dims)


def raster_tiles_keys_f32_reference(sorted_pad, starts, counts, table,
                                    width: int, tile_w: int, tile_h: int,
                                    *, z_clip: bool):
    """Plain torch version of K2a, same values bit for bit."""
    best, attr = _pairs_walk(sorted_pad, starts, counts, table, width,
                             tile_w, tile_h, z_clip)
    return _keys_f32_epilogue(best, attr)


def raster_tiles_flat_u8_mxu_reference(sorted_pad, starts, counts, table,
                                       packed_bg, width: int, tile_w: int,
                                       tile_h: int, *, opaque: bool,
                                       z_clip: bool, mxu: int):
    """Plain torch version of K1-mxu over an affine table
    (:func:`build_table_mxu`): each plane (a_x x + a_y y) + c with every
    operation rounded on its own, table and coordinates first rounded to
    bfloat16 with ``mxu=2``; then K1's coverage, z test, key, strict
    minimum and u8 epilogue on those planes, the channels the winner's
    planes 4 + d.  The kernel accumulates on the tensor cores and is held
    to this within a tolerance, not bit for bit."""
    best, attr = _pairs_walk(sorted_pad, starts, counts, table, width,
                             tile_w, tile_h, z_clip, _check_mxu(mxu))
    return _u8_epilogue(best, attr, packed_bg, opaque)


def raster_tiles_tex_u8_mxu_reference(sorted_pad, starts, counts, table,
                                      tex_packed, tex_dims, packed_bg,
                                      width: int, tile_w: int, tile_h: int,
                                      *, z_clip: bool, mxu: int):
    """Plain torch version of K3's matrix-unit walk: the walk of
    :func:`raster_tiles_flat_u8_mxu_reference`, then K3's texel epilogue
    on the winner's planes 4..6."""
    best, attr = _pairs_walk(sorted_pad, starts, counts, table, width,
                             tile_w, tile_h, z_clip, _check_mxu(mxu))
    return _tex_u8_epilogue(best, attr, tex_packed, tex_dims, packed_bg)


def raster_tiles_bins_f32_reference(bins, counts, table, width: int,
                                    tile_w: int, tile_h: int):
    """Plain torch version of K5, same values bit for bit."""
    nt, K, nrows = counts.shape[-1], bins.shape[-1], table.shape[-2]
    bn = bins.reshape(-1, K)
    tb = table.reshape(-1, ROW_W)

    def rows_at(tiles, slots):
        f = _frame_of(tiles, nt, slots)
        tri = bn[tiles.reshape(f.shape), slots.clamp(max=K - 1)]
        return tb[f * nrows + tri.clamp(0, nrows - 1)]

    best, attr = _walk(counts.reshape(-1).clamp(max=K), rows_at, nt, width,
                       tile_w, tile_h, True)
    return _keys_f32_epilogue(best.reshape(counts.shape + best.shape[1:]),
                              attr)


def raster_tiles_rows_u8_reference(rows, starts, counts, packed_bg,
                                   width: int, tile_w: int, tile_h: int):
    """Plain torch version of K6, same values bit for bit."""
    nt, cap = counts.shape[-1], rows.shape[-2]
    st = starts.reshape(-1)
    rw = rows.reshape(-1, ROW_W)

    def rows_at(tiles, slots):
        f = _frame_of(tiles, nt, slots)
        idx = (st[tiles].reshape(f.shape) + slots).clamp(max=cap - 1)
        return rw[f * cap + idx]

    best, attr = _walk(counts.reshape(-1), rows_at, nt, width, tile_w,
                       tile_h, False)
    return _u8_epilogue(best.reshape(counts.shape + best.shape[1:]), attr,
                    packed_bg, True)


def render_binned_pallas_flat(sorted_pad, starts, counts, table, bg,
                              width: int, height: int, tile_w: int,
                              tile_h: int):
    """Binned raster through K2a, detiled: (keys (H, W) int32 whose low
    IDX_BITS are the winner's run slot, rgba (H, W, D) float32 with bg
    where no triangle covers the pixel) — counterpart of
    ``pallas_raster.render_binned_pallas_flat`` (``:909-929``).  The JAX
    entry's ``Kb`` and ``kcc`` sized the TPU kernel's id window and
    triangle chunk and are not parameters: the run is walked in full."""
    keys, rgba = raster_tiles_keys_f32(sorted_pad, starts, counts, table,
                                       width, tile_w, tile_h, z_clip=True)
    return detile_keys_rgba(keys, rgba, width, height, tile_w, tile_h, bg,
                            table.dtype)


def render_binned_pallas_flat_batch(sorted_pads, starts, counts, tables, bg,
                                    width: int, height: int, tile_w: int,
                                    tile_h: int):
    """B frames of :func:`render_binned_pallas_flat` in one K2a launch:
    sorted_pads (B, Spad), starts and counts (B, NT), tables
    (B, F + 1, ROW_W) -> (keys (B, H, W), rgba (B, H, W, D)) —
    counterpart of ``pallas_raster.render_binned_pallas_flat_batch``
    (``:1354-1392``)."""
    keys, rgba = raster_tiles_keys_f32(sorted_pads, starts, counts, tables,
                                       width, tile_w, tile_h, z_clip=True)
    return detile_keys_rgba(keys, rgba, width, height, tile_w, tile_h, bg,
                            tables.dtype)


def render_binned_pallas_flat_batch_u8(sorted_pads, starts, counts, tables,
                                       bg, width: int, height: int,
                                       tile_w: int, tile_h: int, *,
                                       opaque: bool = False,
                                       z_clip: bool = True, mxu: int = 0):
    """B frames through K1 in one launch, detiled: (B, H, W, 4) uint8 —
    counterpart of ``pallas_raster.render_binned_pallas_flat_batch_u8``
    (``:1010-1045``); inputs as :func:`render_binned_pallas_flat_batch`.
    With ``mxu`` the tables are affine (:func:`build_table_mxu`) and the
    launch is K1-mxu's."""
    kw = dict(opaque=opaque, z_clip=z_clip)
    if mxu:
        packed = raster_tiles_flat_u8_mxu(sorted_pads, starts, counts,
                                          tables, pack_bg(bg), width, tile_w,
                                          tile_h, mxu=mxu, **kw)
    else:
        packed = raster_tiles_flat_u8(sorted_pads, starts, counts, tables,
                                      pack_bg(bg), width, tile_w, tile_h,
                                      **kw)
    return detile_packed(packed, width, height, tile_w, tile_h)


def render_binned_tex_idx_batch(sorted_pads, starts, counts, tables,
                                width: int, height: int, tile_w: int,
                                tile_h: int, tex_dims):
    """B frames through K2b in one launch, detiled: (B, H, W) int32 texel
    indices, -1 for sky — counterpart of ``pallas_raster.
    render_binned_tex_idx_batch`` (``:1048-1078``).  sorted_pads
    (B, Spad), starts and counts (B, NT), tables (B, F + 1, ROW_W); the
    JAX entry's ``Kb`` and ``kcc`` are not parameters (see
    :func:`render_binned_pallas_flat`)."""
    idx = raster_tiles_tex_idx(sorted_pads, starts, counts, tables,
                               tex_dims, width, tile_w, tile_h, z_clip=True)
    return _detile_frames(idx, width, height, tile_w, tile_h)


def render_binned_pallas(bins, counts, A, B, C, zplane_scaled, inv_area,
                         sign, valid, attrs, bg, width: int, height: int,
                         tile_w: int, tile_h: int, return_ids: bool = False):
    """Binned raster through K5 — counterpart of
    ``pallas_raster.render_binned_pallas`` (``:1559-1610``): the row table
    of the triangles, bins (NT, K) from ``raster3d.bin_triangles`` with
    NO_TRI slots sent to its pad row, one K5 launch, the detile.  Returns
    (keys (H, W) int32, rgba (H, W, D) in A's dtype, bg where sky).  The
    key's id bits are the tile's BIN SLOT, or with ``return_ids`` the
    global triangle id.  The JAX entry's ``kcc`` sized the TPU kernel's
    triangle chunk and is not a parameter."""
    K = bins.shape[1]
    table = build_table(A, B, C, zplane_scaled, inv_area, sign, valid, attrs)
    safe = torch.where(bins == NO_TRI, A.shape[0], bins)
    keys, rgba = raster_tiles_bins_f32(safe, counts, table, width, tile_w,
                                       tile_h)
    if return_ids:
        # bin slots -> global triangle ids (pallas_raster.py:1588-1595)
        slot = keys & IDX_MASK
        gid = torch.gather(safe, 1, slot.clamp(max=K - 1).long())
        keys = torch.where(slot != NO_TRI, (keys & ~IDX_MASK) | gid,
                           SKY_KEY)
    return detile_keys_rgba(keys, rgba, width, height, tile_w, tile_h, bg,
                            A.dtype)


def render_binned_pallas_batch(bins, counts, tables, bg, width: int,
                               height: int, tile_w: int, tile_h: int):
    """B frames through K5 in one launch — counterpart of
    ``pallas_raster.render_binned_pallas_batch`` (``:1526-1556``).  bins
    (B, NT, K) with NO_TRI already sent to the pad row, counts (B, NT),
    tables (B, F + 1, ROW_W); each frame's tiles read its own table.
    Returns (keys (B, H, W) int32, rgba (B, H, W, D) in the tables'
    dtype, bg where sky)."""
    keys, rgba = raster_tiles_bins_f32(bins, counts, tables, width, tile_w,
                                       tile_h)
    return detile_keys_rgba(keys, rgba, width, height, tile_w, tile_h, bg,
                            tables.dtype)


def render_binned_dynrows_batch_u8(rows, starts, counts, bg, width: int,
                                   height: int, tile_w: int, tile_h: int,
                                   g: int = 1):
    """B frames through K6 in one launch, detiled: (B, H, W, 4) uint8 —
    counterpart of ``pallas_raster.render_binned_dynrows_batch_u8``
    (``:1302-1351``), bit-equal to
    :func:`render_binned_pallas_flat_batch_u8` (opaque, z_clip off) on
    the same frames.  rows (B, CAP, ROW_W) from
    ``table[sorted_pad[:CAP] & IDX_MASK]``, starts and counts (B, NT).
    ``g``, the TPU kernel's frames a program, is accepted and changes no
    value; its ``kcc`` is not a parameter."""
    if g < 1:
        raise ValueError(f"g must be >= 1, got {g}")
    packed = raster_tiles_rows_u8(rows, starts, counts, pack_bg(bg), width,
                                  tile_w, tile_h)
    return detile_packed(packed, width, height, tile_w, tile_h)


# Kernel K7: the ordered blend walk (csrc/tile_blend.cu)


def build_blend_table(A, B, C, z, inv_area, sign, valid, fuv):
    """The blend walk's float32 row table, (F + 1, ROW_W), NaN rows for
    invalid triangles and for the pad row F; B frames' inputs (a leading B
    on each, ``fuv`` (F, 3, 2) or (B, F, 3, 2)) give (B, F + 1, ROW_W).

    Row layout: 0:9 the sign-folded edges as in :func:`build_table`;
    9:12 the vertex depths z_i; 12 sign; 13 inv_area; 14:17 u_i; 17:20
    v_i.  The kernel recovers each barycentric weight as e_i' (sign
    inv_area), which is e_i inv_area to the bit (a sign flip is exact),
    so the depth and (u, v) are ``raster3d.render_blended``'s sums
    (w0 q0 + w1 q1) + w2 q2 of the raw vertex values."""
    sg = sign[..., None]
    edges = torch.stack([A * sg, B * sg, C * sg], dim=-1).flatten(-2)
    fuv = fuv.to(A.dtype).expand(A.shape[:-1] + fuv.shape[-2:])
    table = torch.cat([edges, z, sg, inv_area[..., None], fuv[..., 0],
                       fuv[..., 1]], dim=-1)
    table = torch.where(valid[..., None], table, float("nan")).to(
        torch.float32)
    table = torch.cat([table, table.new_full(
        table.shape[:-2] + (1, table.shape[-1]), float("nan"))], dim=-2)
    return torch.nn.functional.pad(table, (0, ROW_W - table.shape[-1]))


def _check_blend_inputs(sorted_pad, starts, counts, table, order,
                        opaque_depth, tex_packed, tex_dims, bg, width,
                        height, tile_w, tile_h):
    _check_inputs(sorted_pad, starts, counts, table, tile_w, tile_h,
                  tex_packed=tex_packed, tex_dims=tex_dims)
    _check_tensors(table.device, order=(order, torch.int32),
                   opaque_depth=(opaque_depth, torch.float32),
                   bg=(bg, torch.float32))
    lead = tuple(counts.shape[:-1])
    if order.shape != lead + (table.shape[-2] - 1,):
        raise ValueError(f"order must be {lead + (table.shape[-2] - 1,)}, "
                         f"one face a draw step, got {tuple(order.shape)}")
    if opaque_depth.shape != (height, width):
        raise ValueError(f"opaque_depth must be ({height}, {width}), got "
                         f"{tuple(opaque_depth.shape)}")
    if bg.shape != (4,):
        raise ValueError(f"bg must be (4,), got {tuple(bg.shape)}")
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    if counts.shape[-1] != ntx * nty:
        raise ValueError(f"{counts.shape[-1]} tiles a frame, expected "
                         f"{ntx * nty} at {width}x{height}")


def raster_tiles_blend_u8(sorted_pad, starts, counts, table, order,
                          opaque_depth, tex_packed, tex_dims, bg,
                          width: int, height: int, tile_w: int,
                          tile_h: int):
    """Kernel K7: each tile's run blended in order, one packed u8 RGBA
    int32 per pixel of every tile, (NT, P); B frames (a leading B on
    ``sorted_pad``, ``starts``, ``counts``, ``table`` and ``order``) give
    (B, NT, P) in one launch.

    The run's ids are draw steps: slot j of tile t is step
    s = sorted_pad[starts[t] + j] & IDX_MASK, the row of face
    ``order[s]`` of the blend table (:func:`build_blend_table`), and the
    sort of the binning lists each run in step order.  Each pixel
    (ox + p % tile_w, oy + p // tile_w) starts at ``bg`` (float32, (4,))
    and, for each slot in run order whose triangle covers it (the K3 edge
    test, inclusive) with 0 <= z <= ``opaque_depth[y, x]`` ((H, W)
    float32; slots outside the frame draw nothing), takes the texel
    ``tex_packed[vi * tw + ui]`` of its clamped-nearest affine (u, v),
    as float32 c / 255, and blends rgb = rgb (1 - a) + texel a,
    alpha = max(alpha, a), in float32: ``raster3d.render_blended``'s
    per-pixel arithmetic.  Each channel is then quantised
    clip(v * 255, 0, 255) truncated and packed r | g << 8 | b << 16 |
    a << 24.

    CUDA tensors launch the kernel on the current stream (no sync): one
    block a tile, which walks its whole run; a blend is not a minimum, so
    no run is split across blocks.  CPU tensors run
    :func:`raster_tiles_blend_u8_reference`."""
    _check_tex_tile(tile_w, tile_h)
    _check_blend_inputs(sorted_pad, starts, counts, table, order,
                        opaque_depth, tex_packed, tex_dims, bg, width,
                        height, tile_w, tile_h)
    if _on_cpu(table, "K7"):
        return raster_tiles_blend_u8_reference(
            sorted_pad, starts, counts, table, order, opaque_depth,
            tex_packed, tex_dims, bg, width, height, tile_w, tile_h)
    from . import _kernels
    th, tw = tex_dims
    ntx = (width + tile_w - 1) // tile_w
    out = torch.empty(counts.shape + (tile_w * tile_h,), dtype=torch.int32,
                      device=table.device)
    dev = table.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _kernels.launch_tile_blend(
            sorted_pad.data_ptr(), sorted_pad.shape[-1], starts.data_ptr(),
            counts.data_ptr(), counts.numel(), counts.shape[-1],
            table.data_ptr(), table.shape[-2], order.data_ptr(),
            order.shape[-1], ntx, tile_w, tile_h, opaque_depth.data_ptr(),
            width, height, tex_packed.data_ptr(), tw, th, bg.data_ptr(),
            out.data_ptr(), stream)
    raster_tiles_blend_u8.launches += 1
    return out


raster_tiles_blend_u8.launches = 0


def unpack_texels(texel):
    """Packed u8 texels (int32, r in the low byte) -> (..., 4) float32
    channels c / 255, the divisor a tensor (IEEE division, as the
    kernel's ``__fdiv_rn``; CUDA torch divides by a Python scalar as a
    reciprocal multiply)."""
    c = torch.stack([(texel >> (8 * k)) & 255 for k in range(4)], dim=-1)
    return c.to(torch.float32) / torch.full((), 255.0, device=texel.device)


def raster_tiles_blend_u8_reference(sorted_pad, starts, counts, table,
                                    order, opaque_depth, tex_packed,
                                    tex_dims, bg, width: int, height: int,
                                    tile_w: int, tile_h: int):
    """Plain torch version of K7, same values bit for bit: the runs'
    slots in order, every tile that reaches slot j at once."""
    nt = counts.shape[-1]
    nb = counts.numel()
    P = tile_w * tile_h
    ntx = (width + tile_w - 1) // tile_w
    th, tw = tex_dims
    dev = table.device
    i32 = torch.int32
    spad, nrows, F = sorted_pad.shape[-1], table.shape[-2], order.shape[-1]
    sp, st = sorted_pad.reshape(-1), starts.reshape(-1)
    od, tb = order.reshape(-1), table.reshape(-1, ROW_W)
    b = torch.arange(nb, device=dev)
    t = (b % nt).to(i32)
    p = torch.arange(P, dtype=i32, device=dev)
    xi = (t % ntx * tile_w)[:, None] + p % tile_w
    yi = (t // ntx * tile_h)[:, None] + p // tile_w
    inside = (xi < width) & (yi < height)
    zmax = torch.where(inside, opaque_depth[yi.clamp(max=height - 1).long(),
                                            xi.clamp(max=width - 1).long()],
                       -1.0)
    X, Y = xi.to(torch.float32), yi.to(torch.float32)
    fb = bg.to(torch.float32).expand(nb, P, 4).clone()
    n = counts.reshape(-1)
    for j in range(int(n.max()) if nb else 0):
        act = torch.nonzero(n > j).squeeze(1)
        f = act // nt
        step = sp[f * spad + (st[act] + j).clamp(max=spad - 1)] & IDX_MASK
        face = torch.where(step < F, od[f * F + step.clamp(max=F - 1)],
                           nrows - 1).clamp(max=nrows - 1)
        r = tb[f * nrows + face][:, None, :]              # (n, 1, ROW_W)
        e0, e1, e2 = _edges(r, X[act], Y[act])
        ia = r[..., 12] * r[..., 13]
        w0, w1, w2 = e0 * ia, e1 * ia, e2 * ia
        z = w0 * r[..., 9] + w1 * r[..., 10] + w2 * r[..., 11]
        cov = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (z >= 0.0)
               & (z <= zmax[act]))
        u = w0 * r[..., 14] + w1 * r[..., 15] + w2 * r[..., 16]
        v = w0 * r[..., 17] + w1 * r[..., 18] + w2 * r[..., 19]
        ui = _to_i32(u * tw).clamp(0, tw - 1)
        vi = _to_i32(v * th).clamp(0, th - 1)
        texel = unpack_texels(tex_packed[(vi * tw + ui).long()])
        cur = fb[act]
        a = texel[..., 3:]
        blended = cur[..., :3] * (1 - a) + texel[..., :3] * a
        new = torch.cat([blended, torch.maximum(cur[..., 3:], a)], -1)
        fb[act] = torch.where(cov[..., None], new, cur)
    q = _quant_u8(fb)
    packed = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
              | (q[..., 3] << 24))
    return packed.reshape(counts.shape + (P,))
