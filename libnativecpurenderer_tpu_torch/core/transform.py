"""Canvas-style 2D affine transform math (host side, float64).

Counterpart of ``libnativecpurenderer_tpu/core/transform.py``, pure
Python.  The reference keeps a 6-element column-major affine matrix
``[a, b, c, d, e, f]`` per render context and mutates it on every
transform call (reference ``libNativeCPURenderer.cpp:386-492``).  Point
mapping is

    out_x = a*x + c*y + e
    out_y = b*x + d*y + f

Python floats are C doubles, so with the reference's operation order the
record-time math here is bit-identical to the C++ reference; the device
only sees the *inverse* matrix baked into each recorded draw command.

All functions are pure and operate on 6-tuples of Python floats.
"""

from __future__ import annotations

import math
from typing import Tuple

Mat6 = Tuple[float, float, float, float, float, float]

IDENTITY: Mat6 = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def compose(old: Mat6, a: float, b: float, c: float, d: float, e: float,
            f: float) -> Mat6:
    """Right-multiply ``old`` by ``[a,b,c,d,e,f]`` (``ApplyTransform``,
    cpp:398-411, same operation order)."""
    return (
        old[0] * a + old[2] * b,
        old[1] * a + old[3] * b,
        old[0] * c + old[2] * d,
        old[1] * c + old[3] * d,
        old[0] * e + old[2] * f + old[4],
        old[1] * e + old[3] * f + old[5],
    )


def scale(old: Mat6, sx: float, sy: float) -> Mat6:
    """Reference ``Scale`` (cpp:420-426)."""
    return compose(old, sx, 0.0, 0.0, sy, 0.0, 0.0)


def translate(old: Mat6, tx: float, ty: float) -> Mat6:
    """Reference ``Translate`` (cpp:428-434)."""
    return compose(old, 1.0, 0.0, 0.0, 1.0, tx, ty)


def rotate(old: Mat6, angle: float) -> Mat6:
    """Reference ``Rotate`` (cpp:436-444). ``angle`` in radians."""
    s = math.sin(angle)
    c = math.cos(angle)
    return compose(old, c, s, -s, c, 0.0, 0.0)


def transform_point(m: Mat6, x: float, y: float) -> Tuple[float, float]:
    """Reference ``TransformPointFromMatrix`` (cpp:446-453)."""
    return (m[0] * x + m[2] * y + m[4], m[1] * x + m[3] * y + m[5])


def inverse(m: Mat6) -> Mat6:
    """Reference ``GetInverseTransform`` (cpp:472-492), including its
    degenerate rule: when ``det == 0`` the reference uses
    ``inv_det = 1e9`` rather than failing."""
    a, b, c, d, e, f = m
    det = a * d - b * c
    inv_det = 1.0 / det if det != 0.0 else 1e9
    return (
        d * inv_det,
        -b * inv_det,
        -c * inv_det,
        a * inv_det,
        (c * f - d * e) * inv_det,
        (b * e - a * f) * inv_det,
    )


def is_no_transform(m: Mat6) -> bool:
    """Reference ``IsNoTransform`` (cpp:551-553).

    The reference uses a *sum* test, not an absolute-value test, so e.g.
    a down-scale or a negative translation is classified as "no
    transform".  It selects the axis-aligned fast path of ``DrawTexture``
    (cpp:731-752), so it is replicated exactly for pixel parity.
    """
    return (m[0] - 1.0 + m[1] + m[2] + m[3] - 1.0 + m[4] + m[5]) < 1e-5


def trunc_clamp(v: float) -> int:
    """``int(v)`` (C-cast truncation) after clamping ``|v| > 9e17``,
    infinities included, to +-9e17; NaN raises ``ValueError`` like
    ``int(nan)``.  The JAX package's native record core uses the same
    constant, so both agree bit for bit."""
    if v > 9.0e17:
        v = 9.0e17
    elif v < -9.0e17:
        v = -9.0e17
    return int(v)


def aabb(m: Mat6, x: float, y: float, width: float, height: float,
         max_width: float, max_height: float) -> Tuple[int, int, int, int]:
    """Transformed bounding box of a rect, as the reference computes it
    (``GetBoarder``, cpp:693-718): transform the four corners, take
    min/max, truncate toward zero (C ``(i64)`` cast), clamp to
    ``[0, max_width] x [0, max_height]``.  The returned ``(left, right,
    top, bottom)`` bounds a half-open pixel range ``[left, right) x
    [top, bottom)``."""
    a, b, c, d, e, f = m
    xw = x + width
    yh = y + height
    ltx = a * x + c * y + e
    lty = b * x + d * y + f
    rtx = a * xw + c * y + e
    rty = b * xw + d * y + f
    lbx = a * x + c * yh + e
    lby = b * x + d * yh + f
    rbx = a * xw + c * yh + e
    rby = b * xw + d * yh + f

    left = trunc_clamp(min(min(ltx, rtx), min(lbx, rbx)))
    right = trunc_clamp(max(max(ltx, rtx), max(lbx, rbx)))
    top = trunc_clamp(min(min(lty, rty), min(lby, rby)))
    bottom = trunc_clamp(max(max(lty, rty), max(lby, rby)))

    mw = int(max_width)
    mh = int(max_height)
    left = max(0, min(mw, left))
    right = max(0, min(mw, right))
    top = max(0, min(mh, top))
    bottom = max(0, min(mh, bottom))
    return left, right, top, bottom
