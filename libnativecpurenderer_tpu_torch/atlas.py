"""Texture atlas.

Counterpart of ``libnativecpurenderer_tpu/atlas.py:1-104``.  All textures
a context samples live in one fixed-width ``(AH, ATLAS_WIDTH, 4)`` tensor
(shelf packing); a sampling command references its texture by an
``(ox, oy, w, h)`` region.  There is one store for each (dtype, device),
so contexts on the CPU and on the card, in float32 and float64, each
sample their own.  Regions are never freed, as the reference's Destroy*
functions are intentional no-op leaks (cpp:33-37,356-360).

The store is updated in place.  A flush reads it on the stream that
wrote it, so a command sees every upload made before its flush.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import config


class TextureStore:
    def __init__(self, dtype, device) -> None:
        self.dtype = dtype
        self.device = torch.device(device)
        self.width = config.ATLAS_WIDTH
        self._dev = torch.zeros((config.ATLAS_INIT_HEIGHT, self.width, 4),
                                dtype=dtype, device=self.device)
        # shelves: list of [y, shelf_height, x_used]
        self._shelves: List[List[int]] = []
        self._y_next = 0

    @property
    def atlas(self):
        """The (AH, AW, 4) atlas tensor on the store's device."""
        return self._dev

    @property
    def height(self) -> int:
        return self._dev.shape[0]

    def _grow(self, needed_height: int) -> None:
        new_h = max(self.height * 2, needed_height)
        old = self._dev
        self._dev = torch.zeros((new_h, self.width, 4), dtype=self.dtype,
                                device=self.device)
        self._dev[:old.shape[0]] = old

    def alloc(self, w: int, h: int) -> Tuple[int, int]:
        if w > self.width:
            raise ValueError(
                f"texture width {w} exceeds atlas width {self.width}")
        for shelf in self._shelves:
            if shelf[1] >= h and self.width - shelf[2] >= w:
                ox = shelf[2]
                shelf[2] += w
                return ox, shelf[0]
        # open a new shelf
        y = self._y_next
        if y + h > self.height:
            self._grow(y + h)
        self._shelves.append([y, h, w])
        self._y_next = y + h
        return 0, y

    def upload(self, ox: int, oy: int, data) -> None:
        """data: (h, w, 4) tensor on any device, cast to the store's
        dtype."""
        h, w = data.shape[0], data.shape[1]
        self._dev[oy:oy + h, ox:ox + w] = data.to(self.dtype)

    def add(self, data) -> Tuple[int, int]:
        ox, oy = self.alloc(data.shape[1], data.shape[0])
        self.upload(ox, oy, data)
        return ox, oy


_stores: Dict[tuple, TextureStore] = {}


def get_store(dtype, device) -> TextureStore:
    """The process's store for (dtype, device), created on first use;
    ``dtype`` None means ``config.default_dtype()``.  The device is
    required: no store falls to the CPU when none is named."""
    dtype = dtype or config.default_dtype()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (dtype, device)
    store = _stores.get(key)
    if store is None:
        store = TextureStore(dtype, device)
        _stores[key] = store
    return store


def reset_stores() -> None:
    """Testing hook: drop all atlas state."""
    _stores.clear()
