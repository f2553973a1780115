"""Helpers: parity with the reference binding's ``Helpers`` class
(``libNativeCPURendererPybind.py:11-49``).  Counterpart of
``libnativecpurenderer_tpu/helpers.py``.

The WapperedBytes plumbing existed only to marshal C heap buffers into
Python (h:78-81, cpp:1246-1252); here those helpers are identities kept
for scripts written against the reference binding.
"""

from __future__ import annotations

import random

from .texture import HitEffectTexture, Texture


class Helpers:
    @staticmethod
    def get_wappered_bytes_data_ptr(b: bytes):
        return b

    @staticmethod
    def get_wappered_bytes_data_size(b: bytes) -> int:
        return len(b)

    @staticmethod
    def wappered_bytes_to_python(b: bytes) -> bytes:
        return bytes(b)

    @staticmethod
    def create_milthm_hit_effect_textures(mask: Texture, n: int):
        """pybind:34-49: one random seed, n dissolve thresholds p = i/(n-1),
        fixed color 0x96/0x90/0xfd.  Returns procedural textures: the
        dissolve is evaluated per pixel at draw time
        (``ops/executor.b_hiteffect``)."""
        seed = random.random()
        return [
            HitEffectTexture(mask, seed, i / (n - 1),
                             0x96 / 0xFF, 0x90 / 0xFF, 0xFD / 0xFF)
            for i in range(n)
        ]
