"""Plain PyTorch reference of the 2D canvas: the reference renderer's
draw semantics (libNativeCPURenderer.cpp, after the float64 NumPy oracle
of the repository's first package), one command at a time over its pixel
box, and the u8 read-back.  It imports nothing of the program.

Covered: the state calls (``save_state``, ``restore_state``,
``translate``, ``rotate_degree``, ``scale``, ``set_transform``,
``apply_color_transform``, ``set_color_transform``) and ``set_color``,
``fill_color``, ``draw_rect``, ``draw_line``, ``draw_vertical_grd``,
``draw_vertical_mut_grd``, ``draw_texture`` and ``draw_splitted_texture``
on an RGBA context.  Semantics:

* the matrix is composed on the host in doubles (``transform.py``); a
  pixel (i, j) of a draw's box (``transform.pixel_box``) maps back to
  the draw's own space by the inverse, snapped to a 2^-20 grid, and is
  drawn where that point lies in the rect ``x <= u <= x + w``, ``y <= v
  <= y + h`` (``draw_line``: the even-odd test against its quad);
* ``draw_texture`` under no transform (the sum test) takes the fast
  path: pixels ``i`` from ``trunc(x)`` while ``i < x + w``, no
  membership test, no inverse;
* blend: the colour transform multiplies the source's channels, then
  ``dst = dst * (1 - a) + src * a`` per colour channel, and the stored
  alpha is the source alpha; ``set_color`` stores its colour as given;
* texture: nearest texel after clamping u to [0, tw - 2] (sic) and v to
  [0, th - 2], the coordinates truncated;
* u8: ``(v * 255)`` truncated.

``dtype`` is the arithmetic's precision: float64 for the reference,
bfloat16 for the control.  Each draw argument is cast to it once.  A
``cover`` canvas draws nothing: it keeps the state and lists each draw's
pixel box, the pixels it covers there and, for a blit, the texture and
the flat indices of the texels those pixels read (``covered``: call,
box, mask, texels or None), for the roofline's count.  Its calls are
the draw's name, and ``draw_texture_fast`` for the fast path.
"""

from __future__ import annotations

import math

import torch

from . import transform as xf

SNAP = 1048576.0            # 2^20


def line_quad(x1, y1, x2, y2, width):
    """The four corners of a line's quad (cpp:876-906)."""
    dx, dy = x2 - x1, y2 - y1
    ln = math.sqrt(dx * dx + dy * dy)
    ux, uy = dx / ln, dy / ln
    vx, vy = -uy, ux
    hw = width / 2
    return [(x1 - vx * hw, y1 - vy * hw), (x1 + vx * hw, y1 + vy * hw),
            (x2 + vx * hw, y2 + vy * hw), (x2 - vx * hw, y2 - vy * hw)]


class Canvas:
    def __init__(self, width: int, height: int, device, dtype=torch.float64,
                 cover: bool = False):
        self.width, self.height = width, height
        self.dtype = dtype
        self.device = device
        self.covered = [] if cover else None
        self.buf = None if cover else torch.zeros((height, width, 4),
                                                  dtype=dtype, device=device)
        self.matrix = xf.IDENTITY
        self.color = (1.0, 1.0, 1.0, 1.0)
        self._stack: list = []

    # -- state ------------------------------------------------------------
    def save_state(self):
        self._stack.append((self.matrix, self.color))

    def restore_state(self):
        if self._stack:
            self.matrix, self.color = self._stack.pop()

    def set_transform(self, *m):
        self.matrix = tuple(float(v) for v in m)

    def apply_transform(self, *m):
        self.matrix = xf.compose(self.matrix, *m)

    def translate(self, tx, ty):
        self.matrix = xf.translate(self.matrix, tx, ty)

    def scale(self, sx, sy):
        self.matrix = xf.scale(self.matrix, sx, sy)

    def rotate(self, angle):
        self.matrix = xf.rotate(self.matrix, angle)

    def rotate_degree(self, deg):
        self.rotate(deg * math.pi / 180)

    def set_color_transform(self, r, g, b, a):
        self.color = (r, g, b, a)

    def apply_color_transform(self, r, g, b, a):
        c = self.color
        self.color = (c[0] * r, c[1] * g, c[2] * b, c[3] * a)

    # -- pixels -----------------------------------------------------------
    def _s(self, v):
        """A draw argument in the arithmetic's precision."""
        return torch.tensor(float(v), dtype=self.dtype, device=self.device)

    def _axis(self, lo, hi):
        return torch.arange(lo, hi, device=self.device).to(self.dtype)

    def _local(self, box):
        """The box's pixels mapped back by the inverse matrix and
        snapped: (u, v), each (rows, columns)."""
        x0, x1, y0, y1 = box
        inv = [self._s(v) for v in xf.inverse(self.matrix)]
        X = self._axis(x0, x1)[None, :]
        Y = self._axis(y0, y1)[:, None]
        u = inv[0] * X + inv[2] * Y + inv[4]
        v = inv[1] * X + inv[3] * Y + inv[5]
        return (torch.round(u * SNAP) / SNAP, torch.round(v * SNAP) / SNAP)

    def _rect(self, x, y, w, h):
        """(box, u, v, membership) of the rect under the matrix, or None
        for an empty box."""
        box = xf.pixel_box(self.matrix, x, y, w, h, self.width, self.height)
        if box[0] >= box[1] or box[2] >= box[3]:
            return None
        u, v = self._local(box)
        m = ((u >= self._s(x)) & (u <= self._s(x + w))
             & (v >= self._s(y)) & (v <= self._s(y + h)))
        return box, u, v, m

    def _blend(self, box, mask, r, g, b, a, call=None):
        if self.covered is not None:
            self.covered.append((call, box, mask, None))
            return
        x0, x1, y0, y1 = box
        view = self.buf[y0:y1, x0:x1]
        shape = view.shape[:2]
        ct = [self._s(c) for c in self.color]
        src = torch.stack([torch.broadcast_to(c * k, shape)
                           for c, k in zip((r, g, b), ct)], -1)
        a = torch.broadcast_to(a * ct[3], shape)[..., None]
        rgb = view[..., :3] * (1 - a) + src * a
        new = torch.cat([rgb, a], -1)
        view.copy_(torch.where(mask[..., None], new, view))

    def _blit(self, tex, box, u, v, mask, call):
        """Each pixel of ``mask`` takes its nearest texel at (u, v)."""
        # the clamp and the truncation in doubles: a bfloat16 control
        # cannot hold tw - 2 of a wide texture
        th, tw = tex.shape[0], tex.shape[1]
        u, v = u.double(), v.double()
        u = torch.where(u < 0, torch.zeros_like(u), u)
        u = torch.where(u >= tw - 1, torch.full_like(u, tw - 2), u)
        v = torch.where(v < 0, torch.zeros_like(v), v)
        v = torch.where(v >= th - 1, torch.full_like(v, th - 2), v)
        ui = torch.broadcast_to(u, mask.shape).long()
        vi = torch.broadcast_to(v, mask.shape).long()
        if self.covered is not None:
            self.covered.append((call, box, mask,
                                 (tex, (vi * tw + ui)[mask])))
            return
        t = tex.to(self.dtype)[vi, ui]
        self._blend(box, mask, t[..., 0], t[..., 1], t[..., 2], t[..., 3])

    # -- draws ------------------------------------------------------------
    def set_color(self, r, g, b, a):
        if self.covered is None:
            self.buf[:] = torch.tensor([r, g, b, a], dtype=self.dtype,
                                       device=self.device)

    def fill_color(self, r, g, b, a):
        m = torch.ones((self.height, self.width), dtype=torch.bool,
                       device=self.device)
        self._blend((0, self.width, 0, self.height), m,
                    *(self._s(v) for v in (r, g, b, a)), call="fill_color")

    def draw_rect(self, x, y, w, h, r, g, b, a):
        if w <= 0 or h <= 0:
            return
        got = self._rect(x, y, w, h)
        if got is not None:
            box, _, _, m = got
            self._blend(box, m, *(self._s(v) for v in (r, g, b, a)),
                        call="draw_rect")

    def draw_vertical_grd(self, x, y, w, h, tr, tg, tb, ta, br, bg, bb, ba):
        if w <= 0 or h <= 0:
            return
        got = self._rect(x, y, w, h)
        if got is None:
            return
        box, _, v, m = got
        p = (v - self._s(y)) / self._s(h)
        col = [self._s(t) + (self._s(b) - self._s(t)) * p
               for t, b in ((tr, br), (tg, bg), (tb, bb), (ta, ba))]
        self._blend(box, m, *col, call="draw_vertical_grd")

    def draw_vertical_mut_grd(self, x, y, w, h, steps):
        """N - 1 two-stop gradients (pybind:272-280)."""
        for (p, s), (np_, ns) in zip(steps, steps[1:]):
            self.draw_vertical_grd(x, y + h * p, w, h * (np_ - p), *s, *ns)

    def draw_line(self, x1, y1, x2, y2, width, r, g, b, a):
        if width <= 0 or (x1 == x2 and y1 == y2):
            return
        pts = line_quad(x1, y1, x2, y2, width)
        scr = [xf.apply(self.matrix, *p) for p in pts]
        xs = [p[0] for p in scr]
        ys = [p[1] for p in scr]
        # the reference scans the whole frame; the quad's pixels lie in
        # its mapped corners' box, with a guard of two pixels
        box = (max(0, min(self.width, math.floor(min(xs)) - 2)),
               max(0, min(self.width, math.ceil(max(xs)) + 2)),
               max(0, min(self.height, math.floor(min(ys)) - 2)),
               max(0, min(self.height, math.ceil(max(ys)) + 2)))
        if box[0] >= box[1] or box[2] >= box[3]:
            return
        X, Y = self._local(box)
        res = torch.zeros(X.shape, dtype=torch.bool, device=self.device)
        j = 3
        for i in range(4):
            xi, yi = self._s(pts[i][0]), self._s(pts[i][1])
            xj, yj = self._s(pts[j][0]), self._s(pts[j][1])
            crosses = (yi > Y) != (yj > Y)
            den = yj - yi
            den = torch.where(den != 0, den, torch.ones_like(den))
            xint = (xj - xi) * (Y - yi) / den + xi
            res = res ^ (crosses & (X < xint))
            j = i
        self._blend(box, res, *(self._s(v) for v in (r, g, b, a)),
                    call="draw_line")

    def draw_texture(self, tex, x, y, w, h):
        """``tex``: (th, tw, 4) texels."""
        if w == 0 or h == 0:
            return
        th, tw = tex.shape[0], tex.shape[1]
        sx, sy = self._s(tw / w), self._s(th / h)
        if xf.is_no_transform(self.matrix):
            # cpp:731-752: i from trunc(x) while i < x + w, clipped to
            # the frame by the pixel write
            x0, y0 = int(x), int(y)
            x1, y1 = math.ceil(x + w), math.ceil(y + h)
            box = (max(0, x0), min(self.width, x1),
                   max(0, y0), min(self.height, y1))
            if box[0] >= box[1] or box[2] >= box[3]:
                return
            u = (self._axis(box[0], box[1])[None, :] - self._s(x)) * sx
            v = (self._axis(box[2], box[3])[:, None] - self._s(y)) * sy
            shape = (box[3] - box[2], box[1] - box[0])
            m = torch.ones(shape, dtype=torch.bool, device=self.device)
            call = "draw_texture_fast"
        else:
            got = self._rect(x, y, w, h)
            if got is None:
                return
            box, u, v, m = got
            u = (u - self._s(x)) * sx
            v = (v - self._s(y)) * sy
            call = "draw_texture"
        self._blit(tex, box, u, v, m, call)

    def draw_splitted_texture(self, tex, x, y, w, h, u0, u1, v0, v1):
        if w == 0 or h == 0:
            return
        got = self._rect(x, y, w, h)
        if got is None:
            return
        box, u, v, m = got
        th, tw = tex.shape[0], tex.shape[1]
        tws, ths = self._s(float(tw)), self._s(float(th))
        u = (u - self._s(x)) * self._s(tw / w)
        v = (v - self._s(y)) * self._s(th / h)
        u = (self._s(u0) + (self._s(u1) - self._s(u0)) * u / tws) * tws
        v = (self._s(v0) + (self._s(v1) - self._s(v0)) * v / ths) * ths
        self._blit(tex, box, u, v, m, "draw_splitted_texture")

    def run(self, calls, textures: dict):
        """Replay ``calls`` ([name, *args]; a texture argument a name in
        ``textures``)."""
        for name, *args in calls:
            args = [textures[a] if isinstance(a, str) else a for a in args]
            getattr(self, name)(*args)
        return self

    def uint8(self):
        """(H, W, 4) uint8: each channel ``(v * 255)`` truncated."""
        return torch.trunc(self.buf * 255).to(torch.int64).to(torch.uint8)


def render(static, calls, textures: dict, width: int, height: int, device,
           dtype=torch.float64):
    """The u8 frame of ``static`` then ``calls`` from a zero frame."""
    cv = Canvas(width, height, device, dtype)
    return cv.run(static, textures).run(calls, textures).uint8()
