"""The reference renderer's 2D affine state (libNativeCPURenderer.cpp:
386-492, 551-553, 693-718), in Python floats (C doubles) with its order
of operations: a matrix ``(a, b, c, d, e, f)`` maps (x, y) to
``(a x + c y + e, b x + d y + f)``."""

from __future__ import annotations

import math

IDENTITY = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def compose(m, a, b, c, d, e, f):
    """``ApplyTransform``: ``m`` right-multiplied by (a, ..., f)."""
    return (m[0] * a + m[2] * b, m[1] * a + m[3] * b,
            m[0] * c + m[2] * d, m[1] * c + m[3] * d,
            m[0] * e + m[2] * f + m[4], m[1] * e + m[3] * f + m[5])


def translate(m, tx, ty):
    return compose(m, 1.0, 0.0, 0.0, 1.0, tx, ty)


def scale(m, sx, sy):
    return compose(m, sx, 0.0, 0.0, sy, 0.0, 0.0)


def rotate(m, angle):
    s, c = math.sin(angle), math.cos(angle)
    return compose(m, c, s, -s, c, 0.0, 0.0)


def apply(m, x, y):
    return (m[0] * x + m[2] * y + m[4], m[1] * x + m[3] * y + m[5])


def inverse(m):
    """``GetInverseTransform``, with its rule for a singular matrix."""
    a, b, c, d, e, f = m
    det = a * d - b * c
    inv = 1.0 / det if det != 0.0 else 1e9
    return (d * inv, -b * inv, -c * inv, a * inv, (c * f - d * e) * inv,
            (b * e - a * f) * inv)


def is_no_transform(m) -> bool:
    """``IsNoTransform``: a sum test, so a down-scale or a negative
    translation also counts as none (and takes the texture's fast
    path)."""
    return (m[0] - 1.0 + m[1] + m[2] + m[3] - 1.0 + m[4] + m[5]) < 1e-5


def _trunc(v: float) -> int:
    return int(max(-9.0e17, min(9.0e17, v)))


def pixel_box(m, x, y, w, h, width: int, height: int):
    """``GetBoarder``: the rect's four corners mapped, their extremes
    truncated toward zero and clamped to the frame: the half-open pixel
    box (x0, x1, y0, y1)."""
    pts = [apply(m, px, py) for px, py in
           ((x, y), (x + w, y), (x, y + h), (x + w, y + h))]
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = _trunc(min(xs)), _trunc(max(xs))
    y0, y1 = _trunc(min(ys)), _trunc(max(ys))
    return (max(0, min(width, x0)), max(0, min(width, x1)),
            max(0, min(height, y0)), max(0, min(height, y1)))
