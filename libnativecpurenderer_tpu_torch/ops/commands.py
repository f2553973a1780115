"""Display-list command encoding.

Counterpart of ``libnativecpurenderer_tpu/ops/commands.py``.  The
reference executes every draw call at once as a per-pixel C++ loop
(``libNativeCPURenderer.cpp:720-948,1285-1316``); here the drawing API
records fixed-width commands into a host buffer and ``RenderContext.flush``
executes the list on the device.

Each command is ``(kind: int32, params: float64[PARAM_W])``.  Host-side
state (transform, inverse transform, colour transform, AABB) is baked into
the params at record time with float64 math, matching the C++ double math
bit for bit; the device only evaluates per-pixel work.

Param layout (host float64, cast to the framebuffer dtype at flush):

  common:
    0:6   inverse transform [ia, ib, ic, id, ie, if]
    6:10  pixel AABB  [left, right, top, bottom]  — mask is
          ``left <= px < right  and  top <= py < bottom``  (half-open, the
          reference raster loops are ``for i = left; i < right``, cpp:760)
    10:14 color transform RGBA snapshot (cpp:525-528)

  kind-specific (slot 14+):
    SET_COLOR   14:18 rgba                      (direct store, no blend/ct; cpp:643-657)
    FILL        14:18 rgba                      (full-screen blend with ct; cpp:682-691)
    RECT        14:18 x0, y0, x1, y1            (x1 = x+w, y1 = y+h, host f64)
                18:22 rgba                      (cpp:847-874)
    CIRCLE      14:17 cx, cy, radius
                18:22 rgba                      (cpp:920-948)
    LINE        14:22 quad corners x0,y0,x1,y1,x2,y2,x3,y3 (untransformed space)
                22:26 rgba                      (cpp:876-918, even-odd polygon test :822-845)
    VGRD        14:18 x0, y0, x1, y1
                18    y (top edge), 19 height
                20:24 top rgba, 24:28 bottom rgba   (cpp:1285-1316)
    TEX / TEX_FAST / SPLIT_TEX
                14:18 x0, y0, x1, y1            (draw rect, x1/y1 precomputed)
                18:20 scaleX, scaleY            (tex_w/w, tex_h/h; cpp:728-729)
                20:24 atlas ox, oy, tex_w, tex_h
                24:28 (SPLIT_TEX only) uStart, uEnd, vStart, vEnd (cpp:812-813)
                TEX_FAST is the reference's axis-aligned fast path
                (cpp:731-752): raw pixel coords, *no* membership test, AABB
                set to the exact loop range [trunc(x), x+w) x [trunc(y), y+h).
    HITEFFECT   14:24 same as TEX (atlas region = the mask texture)
                24    seed, 25 t, 26:29 r, g, b, 29 fast-path flag
                (procedural dissolve shader, cpp:1406-1440; evaluated on
                the fly instead of materialised)
    SET_PIXEL   14:16 x, y   16:20 rgba         (direct store; cpp:494-513)
    APPLY_PIXEL 14:16 x, y   16:20 rgba         (blend with ct; cpp:515-549)
"""

from __future__ import annotations

import weakref

import numpy as np

from . import _kernels

PARAM_W = 32

KIND_NOOP = 0
KIND_SET_COLOR = 1
KIND_FILL = 2
KIND_RECT = 3
KIND_CIRCLE = 4
KIND_LINE = 5
KIND_VGRD = 6
KIND_TEX = 7
KIND_TEX_FAST = 8
KIND_SPLIT_TEX = 9
KIND_HITEFFECT = 10
KIND_SET_PIXEL = 11
KIND_APPLY_PIXEL = 12

N_KINDS = 13


class CommandBuffer:
    """Growable host-side record buffer (numpy float64 + int32)."""

    def __init__(self, capacity: int = 256) -> None:
        self.kinds = np.zeros(capacity, dtype=np.int32)
        self.params = np.zeros((capacity, PARAM_W), dtype=np.float64)
        self.n = 0
        # bumped by clear(): shared-texture region recycling reads it to
        # see that the recorded commands were handed off (texture.py)
        self.gen = 0
        # every params array the buffer has held, weakly: a snapshot
        # view keeps its array alive after the buffer grew or was dropped
        self.arrays = [weakref.ref(self.params)]

    def _grow(self) -> None:
        # new arrays that own their memory (np.resize returns a view, of
        # which a snapshot would keep only the base alive)
        n = self.kinds.shape[0]
        kinds = np.zeros(2 * n, dtype=np.int32)
        params = np.zeros((2 * n, PARAM_W), dtype=np.float64)
        kinds[:n] = self.kinds
        params[:n] = self.params
        self.kinds, self.params = kinds, params
        self.arrays.append(weakref.ref(self.params))

    def append(self, kind: int, common, specific) -> None:
        """common = (inv6, aabb4, ct4); specific = flat list for slots 14+."""
        if self.n == self.kinds.shape[0]:
            self._grow()
        i = self.n
        inv, box, ct = common
        self.kinds[i] = kind
        head = (*inv, *box, *ct)
        if specific:
            head = head + tuple(specific)
        p = self.params[i]
        p[:len(head)] = head
        p[len(head):] = 0.0
        self.n = i + 1

    def append_draw(self, kind, m, ct, mode, gx, gy, gw, gh, spec, mw,
                    mh) -> bool:
        """Record one draw in one call of the record core
        (``csrc/record.c``): the inverse of ``m``, the command box of
        ``mode`` (``RenderContext._BOX_*``), ``ct`` and ``spec``, as
        ``RenderContext._record_draw``'s Python body records them, bit
        for bit.  Returns False, recording nothing, where the core is not
        built or declines the draw."""
        core = _kernels.record_core()
        if core is None:
            return False
        if self.n == self.kinds.shape[0]:
            self._grow()
        if not core.record_draw(self.kinds, self.params, self.n, kind, m,
                                ct, mode, gx, gy, gw, gh,
                                spec if spec else None, mw, mh):
            return False
        self.n += 1
        return True

    def clear(self) -> None:
        self.n = 0
        self.gen += 1

    def snapshot(self):
        """Return (kinds, params) views of the recorded region."""
        return self.kinds[: self.n], self.params[: self.n]
