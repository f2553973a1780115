"""Display-list executor semantics, as plain torch.

Counterpart of ``libnativecpurenderer_tpu/ops/executor.py``: the branch
math of the 13 command kinds, the blend and the u8 quantisation, one
torch op per JAX op in the same order.  It is the spec the port is held
to: the canvas kernel K4 (``canvas_kernel.render_span``) computes the
arithmetic kinds and the texture blits bit for bit as
:func:`render_commands` does, and ``RenderContext.flush`` runs the hit
effects through it.  The JAX
package's ``lax.scan``/``lax.switch`` structure, patch buckets and mesh
taints are XLA machinery and have no counterpart here.

Semantics (see ``ops/commands.py`` for the encoding):
  * blend: ``dst = dst*(1-a) + src*a``; stored alpha = post-color-transform
    source alpha (cpp:515-549 ``ApplyPixel``, including the :543-546 quirk
    that the framebuffer alpha is the *source* alpha, not a composite).
  * color transform is a per-command RGBA multiplier snapshot (cpp:525-528).
  * texture sampling is nearest-neighbour with the reference's clamp quirk
    (u clamped to [0, w-2]: cpp:555-573).
  * AABBs are computed on the host with C-cast truncation semantics
    (core/transform.aabb) and enforced as part of the pixel mask, because
    the reference's loop bounds are observable at rect edges.

Every elementwise op is its own torch op, so nothing fuses a multiply into
an add, on the CPU or on the card; a divisor is always a tensor (CUDA
divides by a Python scalar as a multiply by its reciprocal).  The
framebuffer is ``(H, W, 4)``; RGB contexts never read channel 3 back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import commands as C
from . import noise
from .sampling import _to_i32, clamp_coord

# Membership snap grid: 2^-20 px (executor.py:49).  Inverse-mapped
# coordinates are snapped before every membership test and shading use,
# as in the JAX executors and the NumPy oracle.
SNAP_SCALE = 1048576.0

# the kinds whose colour comes from the texture atlas or the noise shader
SAMPLING_KINDS = frozenset((C.KIND_TEX, C.KIND_TEX_FAST, C.KIND_SPLIT_TEX,
                            C.KIND_HITEFFECT))


def _aabb_mask(p, X, Y):
    return (X >= p[6]) & (X < p[7]) & (Y >= p[8]) & (Y < p[9])


def _snap(v):
    """Snap an inverse-mapped coordinate to the 2^-20 subpixel grid
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    return torch.round(v * SNAP_SCALE) * (1.0 / SNAP_SCALE)


def _inv_point(p, X, Y):
    # TransformPointFromMatrix with the inverse matrix (cpp:446-453,
    # 754-763): (a*X + c*Y) + e, then the snap
    inv_x = p[0] * X + p[2] * Y + p[4]
    inv_y = p[1] * X + p[3] * Y + p[5]
    return _snap(inv_x), _snap(inv_y)


def _rect_member(p, ix, iy):
    return (ix >= p[14]) & (ix <= p[16]) & (iy >= p[15]) & (iy <= p[17])


def _ct(p, r, g, b, a):
    return r * p[10], g * p[11], b * p[12], a * p[13]


def _sample_atlas(atlas, u, v, p):
    """Nearest-neighbour sample at float texel coords (u, v) from the atlas
    region p[20:24] = (ox, oy, tw, th): clamp u to [0, tw-2] (sic), v to
    [0, th-2], truncate (cpp:555-573).  Indices are taken as ``jnp.take``
    takes them: a negative flat index counts from the end, one out of
    range reads NaN.  Returns (texel (..., 4), clamped u, clamped v)."""
    ox, oy, tw, th = p[20], p[21], p[22], p[23]
    u = clamp_coord(u, tw)
    v = clamp_coord(v, th)
    ui = _to_i32(u) + _to_i32(ox)
    vi = _to_i32(v) + _to_i32(oy)
    flat = vi * atlas.shape[1] + ui
    n = atlas.shape[0] * atlas.shape[1]
    flat = torch.where(flat < 0, flat + n, flat)
    valid = (flat >= 0) & (flat < n)
    texel = atlas.reshape(-1, 4)[flat.clamp(0, n - 1).long()]
    return torch.where(valid[..., None], texel, math.nan), u, v


def _tex_uv(p, ix, iy):
    # u = (invX - x) * scaleX (cpp:743-744, 770-771)
    return (ix - p[14]) * p[18], (iy - p[15]) * p[19]


# -- branches: (p, X, Y, atlas) -> (mask, (r, g, b, a), store) ------------

def b_set_color(p, X, Y, atlas):
    # SetColor stores raw rgba, no blend, no colour transform
    # (cpp:643-657), masked by the command AABB: full frame for the public
    # call, plus the column box of the RGB-mode corruption (context.py)
    return _aabb_mask(p, X, Y), (p[14], p[15], p[16], p[17]), True


def b_fill(p, X, Y, atlas):
    # FillColor = ApplyPixel over every pixel (cpp:682-691): ct + blend
    return (torch.ones(X.shape, dtype=torch.bool, device=X.device),
            _ct(p, p[14], p[15], p[16], p[17]), False)


def b_rect(p, X, Y, atlas):
    ix, iy = _inv_point(p, X, Y)
    m = _rect_member(p, ix, iy) & _aabb_mask(p, X, Y)
    return m, _ct(p, p[18], p[19], p[20], p[21]), False


def b_circle(p, X, Y, atlas):
    ix, iy = _inv_point(p, X, Y)
    dx = ix - p[14]
    dy = iy - p[15]
    m = (torch.sqrt(dx * dx + dy * dy) <= p[16]) & _aabb_mask(p, X, Y)
    return m, _ct(p, p[18], p[19], p[20], p[21]), False


def b_line(p, X, Y, atlas):
    # even-odd point-in-quad test (cpp:822-845) on inverse coords
    ix, iy = _inv_point(p, X, Y)
    res = torch.zeros(X.shape, dtype=torch.bool, device=X.device)
    pts = [(p[14], p[15]), (p[16], p[17]), (p[18], p[19]), (p[20], p[21])]
    j = 3
    for i in range(4):
        xi, yi = pts[i]
        xj, yj = pts[j]
        den = yj - yi
        safe_den = torch.where(den != 0.0, den, torch.ones_like(den))
        crosses = (yi > iy) != (yj > iy)
        xint = (xj - xi) * (iy - yi) / safe_den + xi
        res = res ^ (crosses & (ix < xint))
        j = i
    m = res & _aabb_mask(p, X, Y)
    return m, _ct(p, p[22], p[23], p[24], p[25]), False


def b_vgrd(p, X, Y, atlas):
    ix, iy = _inv_point(p, X, Y)
    m = _rect_member(p, ix, iy) & _aabb_mask(p, X, Y)
    t = (iy - p[18]) / p[19]  # (invY - y) / height   cpp:1308

    def lerp(lo, hi):
        return lo + (hi - lo) * t

    rgba = (lerp(p[20], p[24]), lerp(p[21], p[25]), lerp(p[22], p[26]),
            lerp(p[23], p[27]))
    return m, _ct(p, *rgba), False


def _tex_common(p, X, Y, atlas, ix, iy, member):
    u, v = _tex_uv(p, ix, iy)
    texel, _, _ = _sample_atlas(atlas, u, v, p)
    rgba = _ct(p, texel[..., 0], texel[..., 1], texel[..., 2],
               texel[..., 3])
    return member & _aabb_mask(p, X, Y), rgba, False


def b_tex(p, X, Y, atlas):
    ix, iy = _inv_point(p, X, Y)
    return _tex_common(p, X, Y, atlas, ix, iy, _rect_member(p, ix, iy))


def b_tex_fast(p, X, Y, atlas):
    # axis-aligned fast path (cpp:731-752): raw pixel coords, no
    # membership test; the AABB *is* the loop range
    return _tex_common(p, X, Y, atlas, X, Y,
                       torch.ones(X.shape, dtype=torch.bool,
                                  device=X.device))


def b_split_tex(p, X, Y, atlas):
    ix, iy = _inv_point(p, X, Y)
    member = _rect_member(p, ix, iy)
    u, v = _tex_uv(p, ix, iy)
    # UV sub-range remap (cpp:812-813)
    tw, th = p[22], p[23]
    u = (p[24] + (p[25] - p[24]) * u / tw) * tw
    v = (p[26] + (p[27] - p[26]) * v / th) * th
    texel, _, _ = _sample_atlas(atlas, u, v, p)
    rgba = _ct(p, texel[..., 0], texel[..., 1], texel[..., 2],
               texel[..., 3])
    return member & _aabb_mask(p, X, Y), rgba, False


def b_hiteffect(p, X, Y, atlas):
    # Procedural dissolve texture (cpp:1417-1440) evaluated per screen
    # pixel: texel (tx, ty) of the materialised texture holds
    # noise(x=ty/W, y=tx/H) (the reference writes the noise buffer column
    # major, cpp:1432-1435) times the mask's alpha at (tx, ty).  p[29]
    # selects the axis-aligned fast path (raw coords, no membership test).
    fast = p[29] > 0.0
    ivx, ivy = _inv_point(p, X, Y)
    ix = torch.where(fast, X, ivx)
    iy = torch.where(fast, Y, ivy)
    member = fast | _rect_member(p, ix, iy)
    u, v = _tex_uv(p, ix, iy)
    texel, uc, vc = _sample_atlas(atlas, u, v, p)
    tw, th = p[22], p[23]
    tx = torch.floor(uc)
    ty = torch.floor(vc)
    na = noise.hit_effect_alpha(ty / tw, tx / th, p[24], p[25])
    a = na * texel[..., 3]
    return (member & _aabb_mask(p, X, Y), _ct(p, p[26], p[27], p[28], a),
            False)


def b_set_pixel(p, X, Y, atlas):
    m = (X == p[14]) & (Y == p[15])
    return m, (p[16], p[17], p[18], p[19]), True


def b_apply_pixel(p, X, Y, atlas):
    m = (X == p[14]) & (Y == p[15])
    return m, _ct(p, p[16], p[17], p[18], p[19]), False


BRANCHES = {
    C.KIND_SET_COLOR: b_set_color, C.KIND_FILL: b_fill,
    C.KIND_RECT: b_rect, C.KIND_CIRCLE: b_circle, C.KIND_LINE: b_line,
    C.KIND_VGRD: b_vgrd, C.KIND_TEX: b_tex, C.KIND_TEX_FAST: b_tex_fast,
    C.KIND_SPLIT_TEX: b_split_tex, C.KIND_HITEFFECT: b_hiteffect,
    C.KIND_SET_PIXEL: b_set_pixel, C.KIND_APPLY_PIXEL: b_apply_pixel,
}


def _blend_into(fb, mask, rgba, store: bool) -> None:
    """Blend one command's source into ``fb`` (a view) in place
    (``executor.py:321``): ``fb*(1-a) + src*a`` per colour channel, or the
    source itself where ``store``; alpha takes the source alpha; pixels
    outside ``mask`` keep their value."""
    src = torch.stack([torch.broadcast_to(c, mask.shape) for c in rgba],
                      dim=-1)
    src_rgb = src[..., :3]
    src_a = src[..., 3:4]
    if store:
        new_rgb = src_rgb
    else:
        new_rgb = fb[..., :3] * (1.0 - src_a) + src_rgb * src_a
    new = torch.cat([new_rgb, src_a], dim=-1)
    fb.copy_(torch.where(mask[..., None], new, fb))


def render_commands(fb, kinds, params, atlas=None, window=None):
    """Fold a command list into ``fb`` in place and return it.

    fb: (H, W, 4) float; kinds: host sequence of int kinds (they pick the
    branch, so they are read on the host); params: (N, PARAM_W) in
    fb.dtype on fb's device; atlas: (AH, AW, 4) fb.dtype, needed only by
    the sampling kinds.  ``window`` = (x0, x1, y0, y1) evaluates every
    command on the pixels x0 <= X < x1, y0 <= Y < y1 only, with their
    frame coordinates; it equals a full-frame evaluation when every pixel
    the commands' masks admit lies inside it (see :func:`sample_window`).
    """
    H, W = fb.shape[0], fb.shape[1]
    x0, x1, y0, y1 = window if window is not None else (0, W, 0, H)
    X = torch.arange(x0, x1, dtype=fb.dtype, device=fb.device).expand(
        y1 - y0, x1 - x0)
    Y = torch.arange(y0, y1, dtype=fb.dtype, device=fb.device)[:, None] \
        .expand(y1 - y0, x1 - x0)
    view = fb[y0:y1, x0:x1]
    for i, kind in enumerate(kinds):
        if kind == C.KIND_NOOP:
            continue
        mask, rgba, store = BRANCHES[int(kind)](params[i], X, Y, atlas)
        _blend_into(view, mask, rgba, store)
    return fb


def sample_window(box, width: int, height: int):
    """The integer window (x0, x1, y0, y1) of the pixels a command's AABB
    mask can admit, clamped to the frame, or None if it admits none.

    ``box`` is the command's p[6:10] in the framebuffer's dtype (numpy):
    an integer X satisfies ``X >= left`` iff ``X >= ceil(left)`` and
    ``X < right`` iff ``X < ceil(right)``; NaN bounds admit nothing."""
    with np.errstate(invalid="ignore"):
        x0, x1 = np.clip(np.ceil(box[0:2]), 0, width)
        y0, y1 = np.clip(np.ceil(box[2:4]), 0, height)
    if not (x0 < x1 and y0 < y1):
        return None
    return int(x0), int(x1), int(y0), int(y1)


def quantize_u8(fb, channels: int = 4):
    """GetBufferAsUInt8 semantics (cpp:52-57): ``(u8)(v * 255)``, C-cast
    truncation with wraparound, not rounding or clamping.  Goes through
    int32 (as XLA converts) so that values above 1 and below 0 wrap."""
    return _to_i32(fb[..., :channels] * 255.0).to(torch.uint8)
