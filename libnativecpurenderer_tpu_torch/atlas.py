"""Texture atlas.

Counterpart of ``libnativecpurenderer_tpu/atlas.py:1-104``.  All textures
a context samples live in one fixed-width ``(AH, ATLAS_WIDTH, 4)`` tensor
(shelf packing); a sampling command references its texture by an
``(ox, oy, w, h)`` region.  There is one store for each (dtype, device),
so contexts on the CPU and on the card, in float32 and float64, each
sample their own.  A texture's region is not freed when the texture
dies, as the reference's Destroy* functions are intentional no-op leaks
(cpp:33-37,356-360); the superseded regions of a shared texture that a
recording proxy samples are recycled (``texture.py``, with the dispatch
fences below).

The store is updated in place.  A flush reads it on the stream that
wrote it, so a command sees every upload made before its flush, and none
made after: everything runs on the device's current stream.
"""

from __future__ import annotations

import weakref
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
    _pipelines.clear()


# -- dispatch fences (``libnativecpurenderer_tpu/atlas.py:106-147``) ------
# Each frame pipeline counts its flushes: a fence means that every frame
# pending in it was queued on the stream.  A retired shared-texture
# region is reused once every pipeline alive when its samplers let go
# has fenced again or died (texture.py); counters of their own keep
# interleaved pipelines from stalling each other.

_pipelines: "weakref.WeakSet" = weakref.WeakSet()


def register_pipeline(pipe) -> None:
    pipe._fence_count = 0
    _pipelines.add(pipe)


def dispatch_fence(pipe) -> None:
    """Called by a pipeline once it has queued its pending frames."""
    pipe._fence_count += 1


def pipeline_stamp():
    """(weak reference, fence count) of every live pipeline."""
    return [(weakref.ref(p), p._fence_count) for p in _pipelines]


def stamp_passed(stamp) -> bool:
    """True once every stamped pipeline has fenced again or died."""
    return all(p() is None or p()._fence_count > c for p, c in stamp)
