"""Host-side render state: transform, colour transform, save/restore stack.

Counterpart of ``libnativecpurenderer_tpu/core/state.py``.  Mirrors the
reference's ``RenderContextState`` stack (``libNativeCPURenderer.cpp:
277-309``): the stack snapshots exactly the 2D transform matrix and the
RGBA colour-transform multiplier.  Draw commands are recorded with the
state baked in, which equals the reference reading the live state inside
every per-pixel loop, since the state cannot change mid-draw-call.
"""

from __future__ import annotations

from typing import List, Tuple

from . import transform as xf

ColorT = Tuple[float, float, float, float]


class RenderState:
    __slots__ = ("matrix", "color", "_stack")

    def __init__(self) -> None:
        self.matrix: xf.Mat6 = xf.IDENTITY
        self.color: ColorT = (1.0, 1.0, 1.0, 1.0)
        self._stack: List[Tuple[xf.Mat6, ColorT]] = []

    # -- transform ops (reference cpp:386-444) ------------------------------
    def set_transform(self, a, b, c, d, e, f) -> None:
        self.matrix = (a, b, c, d, e, f)

    def apply_transform(self, a, b, c, d, e, f) -> None:
        self.matrix = xf.compose(self.matrix, a, b, c, d, e, f)

    def scale(self, sx, sy) -> None:
        self.matrix = xf.scale(self.matrix, sx, sy)

    def translate(self, tx, ty) -> None:
        self.matrix = xf.translate(self.matrix, tx, ty)

    def rotate(self, angle) -> None:
        self.matrix = xf.rotate(self.matrix, angle)

    # -- colour transform (reference cpp:623-641) ---------------------------
    def set_color_transform(self, r, g, b, a) -> None:
        self.color = (r, g, b, a)

    def apply_color_transform(self, r, g, b, a) -> None:
        c = self.color
        self.color = (c[0] * r, c[1] * g, c[2] * b, c[3] * a)

    # -- stack (reference cpp:277-309) --------------------------------------
    def save(self) -> None:
        self._stack.append((self.matrix, self.color))

    def restore(self) -> bool:
        if not self._stack:
            return False
        self.matrix, self.color = self._stack.pop()
        return True
