"""Texture objects.

Counterpart of ``libnativecpurenderer_tpu/texture.py``, with API parity
with the reference binding's ``Texture`` / ``PtrCreatedTexture``
(``libNativeCPURendererPybind.py:369-440``): constructor from raw bytes
(uint8 or float64, /255 conversion per ``CreateTextureUInt8``
cpp:337-354), ``from_pilimg``, ``resample``.  RGB textures are stored with
alpha=1: the reference leaves the sampled alpha of 3-channel textures
uninitialised (``DrawTexture`` cpp:746-748), which is undefined
behaviour replaced by the only sensible defined value.

A texture keeps its texels as an ``(h, w, 4)`` tensor in the default
dtype of its creation (as the JAX package rounds them into the default
dtype's atlas).  It has no device of its own: the first time a context
samples it, :meth:`Texture.region_for` uploads it into that context's
store (one per dtype and device, ``atlas.py``) and remembers the region.

A shared texture (``RenderContext.as_texture_shared``) is refreshed in
place when a flushing context samples it, and into fresh regions when a
recording proxy does; the superseded regions are recycled once no
pending frame can read them (see "shared-texture region recycling"
below).
"""

from __future__ import annotations

import typing
import weakref

import numpy as np
import torch

from . import atlas as atlas_mod
from . import config
from .ops import noise, sampling


class Texture:
    def __init__(self, width: int, height: int, enableAlpha: bool,
                 data: typing.ByteString, is_uint8: bool = True):
        channels = 4 if enableAlpha else 3
        itemsize = 1 if is_uint8 else 8
        if width * height * channels * itemsize != len(data):
            raise ValueError("data size not match")
        if is_uint8:
            arr = np.frombuffer(bytes(data), dtype=np.uint8).astype(
                np.float64) / 255.0
        else:
            arr = np.frombuffer(bytes(data), dtype=np.float64).copy()
        self._init_from_array(torch.from_numpy(
            arr.reshape(height, width, channels)), enableAlpha)

    # set by RenderContext.as_texture_shared: the context whose live
    # framebuffer this texture aliases (cpp:377-384)
    _shared_ctx = None

    def _init_from_array(self, arr, enableAlpha: bool) -> None:
        h, w = arr.shape[0], arr.shape[1]
        if arr.shape[2] == 3:
            arr = torch.cat([arr, torch.ones((h, w, 1), dtype=arr.dtype,
                                             device=arr.device)], dim=2)
        self.width = int(w)
        self.height = int(h)
        self.enableAlpha = bool(enableAlpha)
        self._data = arr.to(config.default_dtype())
        self._regions = weakref.WeakKeyDictionary()   # store -> (ox, oy)

    @classmethod
    def _from_array(cls, arr, enableAlpha: bool) -> "Texture":
        """A texture of an (h, w, 3|4) numpy array or tensor."""
        tex = cls.__new__(cls)
        tex._init_from_array(torch.as_tensor(arr), enableAlpha)
        return tex

    @classmethod
    def _from_device_array(cls, fb, enableAlpha: bool) -> "Texture":
        """A texture of a copy of an (h, w, 4) tensor (a framebuffer,
        which its context goes on updating in place)."""
        return cls._from_array(fb.clone(), enableAlpha)

    def region_for(self, store):
        """(ox, oy) of this texture's texels in ``store``, uploaded there
        on first use."""
        region = self._regions.get(store)
        if region is None:
            region = store.add(self._data)
            self._regions[store] = region
        return region

    def _refresh_shared(self) -> None:
        """Re-snapshot the aliased framebuffer into this texture.

        The reference's shared texture points straight at the context's
        buffer (cpp:377-384), so draws issued after sharing are visible
        the next time the texture is sampled.  The sampling context calls
        this whenever it records a draw using the texture after the owner
        drew: same observable states for every sample-after-draw
        sequence.  (A self-overlapping blit reads its source as of the
        command's start, not its own partial output.)  The regions are
        updated in place, unless a command that another context recorded
        may not have run yet reads them (its guard holds, or a recording
        proxy recorded it: its frame may wait in a pipeline): then the
        texels take new regions (:meth:`_refresh_shared_new_region`), so
        that command still sees the state of its record point, as the
        reference's draw would."""
        ctx = self._shared_ctx
        if ctx is None:
            return
        if any(g[3] or not self._guard_released(g)
               for g in getattr(self, "_cur_samplers", {}).values()):
            self._refresh_shared_new_region()
            return
        ctx.flush()
        self._data = ctx._fb.clone()
        for store, (ox, oy) in self._regions.items():
            store.upload(ox, oy, self._data)

    # -- shared-texture region recycling ---------------------------------
    # (``libnativecpurenderer_tpu/texture.py:121-228``.)  A recording
    # proxy samples a shared texture whose owner redraws every frame; each
    # refresh moves the texels into new regions so that frames recorded
    # earlier keep sampling the old ones, and without reuse a long render
    # grows the atlas without end.  A retired region set returns to the
    # texture's pool once
    #   (a) every recorder that sampled it released its guard: its record
    #       buffer was cleared (``gen`` moved on; a frame is submitted
    #       before its buffer is cleared), or the buffer died and so did
    #       every params array it held (a preparer's un-submitted
    #       snapshot views keep theirs alive, across a grow too), and
    #   (b) every pipeline alive when the guards released has fenced
    #       since (``atlas.dispatch_fence``): the frames pending then,
    #       which may read the set, are queued.  A recycled region is
    #       written after that, on the same stream, so after they read it.
    # With no live pipeline, a set a no-flush proxy sampled stays retired
    # for good: its frames run where no fence can be seen.
    #
    # The region dict of a texture is only ever mutated in place: a hit
    # effect reads it through its mask.  Retired sets and the pool hold
    # their stores weakly, as ``_regions`` does (``atlas.reset_stores``).

    def _shared_gc_init(self) -> None:
        if not hasattr(self, "_retired"):
            # entries: [guards, {store: (ox, oy)}, stamp, no_flush]
            self._retired = []
            self._region_pool = weakref.WeakKeyDictionary()  # -> [(ox, oy)]
            self._cur_samplers = {}   # id(cmds) -> guard

    def _note_recording_sampler(self, ctx) -> None:
        """Record that ``ctx`` recorded a command sampling the current
        regions (``RenderContext._tex_specific`` calls this for every
        draw of a shared texture, and of a hit effect of one)."""
        self._shared_gc_init()
        cmds = ctx._cmds
        self._cur_samplers[id(cmds)] = (
            weakref.ref(cmds), cmds.arrays, cmds.gen, ctx._no_flush_record)

    @staticmethod
    def _guard_released(guard) -> bool:
        cmds_ref, arrays, gen, _ = guard
        cmds = cmds_ref()
        if cmds is not None:
            return cmds.gen > gen
        # the buffer is gone (a preparer swapped it out): released only
        # once no snapshot view of any of its params arrays is alive
        return all(a() is None for a in arrays)

    def _reclaim_retired(self) -> None:
        keep = []
        for entry in self._retired:
            guards, regions, stamp, no_flush = entry
            if stamp is None:
                if all(self._guard_released(g) for g in guards):
                    stamp = atlas_mod.pipeline_stamp()
                    if not stamp and no_flush:
                        stamp = False     # no fence to wait for: hold
                    entry[2] = stamp
                keep.append(entry)
            elif stamp is not False and atlas_mod.stamp_passed(stamp):
                for store, r in regions.items():
                    self._region_pool.setdefault(store, []).append(r)
            else:
                keep.append(entry)
        self._retired = keep

    def _pool_alloc(self, store):
        pool = self._region_pool.get(store)
        if pool:
            return pool.pop()
        return store.alloc(self.width, self.height)

    def _refresh_shared_new_region(self) -> None:
        """The refresh for a recording proxy: snapshot the owner's
        framebuffer into a new region of every store the texture lives
        in, so that commands recorded before it keep sampling the old
        texels when their batch runs.  The superseded regions are retired
        and recycled once no pending frame can read them."""
        ctx = self._shared_ctx
        if ctx is None:
            return
        ctx.flush()
        self._data = ctx._fb.clone()
        self._shared_gc_init()
        guards = list(self._cur_samplers.values())
        self._retired.append([guards,
                              weakref.WeakKeyDictionary(self._regions),
                              None, any(g[3] for g in guards)])
        self._cur_samplers = {}
        self._reclaim_retired()
        for store in list(self._regions):
            ox, oy = self._pool_alloc(store)
            store.upload(ox, oy, self._data)
            self._regions[store] = (ox, oy)

    @property
    def _source(self) -> "Texture":
        """The texture whose regions a command sampling this one reads."""
        return self

    def to_numpy(self) -> np.ndarray:
        """The (h, w, 4) texel data on the host."""
        return self._data.cpu().numpy()

    # -- parity API ------------------------------------------------------
    def resample(self, width: int, height: int,
                 filter: str = "nearest") -> "Texture":
        """ResampleTexture (cpp:950-976).  ``filter="bilinear"`` opts into
        the smoother kernel the reference left commented out
        (cpp:575-620); the parity default is nearest."""
        fn = (sampling.resample_region_bilinear if filter == "bilinear"
              else sampling.resample_region)
        out = fn(self._data, 0, 0, float(self.width), float(self.height),
                 int(width), int(height))
        return Texture._from_array(out, self.enableAlpha)

    @staticmethod
    def from_pilimg(img) -> "Texture":
        from PIL import Image

        if not isinstance(img, Image.Image):
            raise TypeError("img must be a PIL.Image.Image")
        if img.mode not in ("RGB", "RGBA"):
            img = img.convert("RGBA")
        return Texture(img.width, img.height, img.mode == "RGBA",
                       img.tobytes())


class PtrCreatedTexture(Texture):
    """Parity alias: the ctypes binding distinguished pointer-wrapped
    textures (pybind:437-440); here all textures are equal."""

    def __init__(self, tex: Texture):
        self.__dict__.update(tex.__dict__)


class HitEffectTexture(Texture):
    """Procedural Milthm hit-effect dissolve texture.

    The reference materialises these per (seed, t) via
    ``CreateMilthmHitEffectTexture`` (cpp:1417-1440).  Here the draw
    command evaluates the noise per covered screen pixel instead
    (``ops/executor.b_hiteffect``); only the mask texture occupies the
    atlas.
    """

    def __init__(self, mask: Texture, seed: float, t: float,
                 r: float, g: float, b: float):
        if not mask.enableAlpha:
            # reference returns nullptr (cpp:1418)
            raise ValueError("hit-effect mask must have an alpha channel")
        self.width = mask.width
        self.height = mask.height
        self.enableAlpha = True
        self._mask = mask
        self.seed = float(seed)
        self.t = float(t)
        self.rgb = (float(r), float(g), float(b))

    # the mask's texels and regions, read through the mask, so that its
    # refreshes show through (a command samples the mask's region)
    @property
    def _data(self):
        return self._mask._data

    @property
    def _regions(self):
        return self._mask._regions

    @property
    def _source(self) -> Texture:
        return self._mask._source

    def materialize(self) -> Texture:
        """The equivalent concrete texture (for resample and readback).

        Matches the reference's column-major store quirk (cpp:1432-1435):
        texel (x, y) holds noise evaluated at (y/width, x/height) times
        the mask's alpha at (x, y).  Requires a square mask, as all
        reference call sites use (pybind:34-49).
        """
        if self.width != self.height:
            raise ValueError("hit-effect materialisation requires square "
                             "mask")
        mask = self._data
        w = self.width
        kw = dict(dtype=mask.dtype, device=mask.device)
        wt = torch.tensor(float(w), **kw)
        tx = torch.arange(w, **kw).expand(w, w)
        ty = torch.arange(w, **kw)[:, None].expand(w, w)
        na = noise.hit_effect_alpha(ty / wt, tx / wt, self.seed, self.t)
        a = na * mask[..., 3]
        rgb = torch.tensor(self.rgb, **kw).expand(w, w, 3)
        return Texture._from_array(torch.cat([rgb, a[..., None]], dim=-1),
                                   True)
