"""RenderContext: the Canvas2D-style drawing API, record-then-execute.

Counterpart of ``libnativecpurenderer_tpu/context.py:1-230,404-705``, with
API parity with the reference binding's ``RenderContext``
(``libNativeCPURendererPybind.py:51-300``).  Draw calls record a
display-list command on the host (float64 math identical to the C++
doubles); :meth:`RenderContext.flush` executes the list on the context's
device:
  * every maximal run of commands K4 takes (``canvas_kernel.
    KERNEL_KINDS``: the arithmetic kinds and the texture blits) goes to
    one call of the K4 wrapper (``canvas_kernel.render_span``: the CUDA
    kernel on the card, its plain version on the CPU);
  * every hit effect runs the executor's branch as torch ops over the
    integer window of its AABB (``executor.sample_window``), which
    equals a full-frame evaluation.
The framebuffer is updated in place.  A flush makes no host sync; reads
(``numpy_buffer``, ``uint8_buffer``, ``get_color``, ``as_pilimg``) flush
first and then sync.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import atlas as atlas_mod
from . import config, interop, tracing
from .core import transform as xf
from .core.state import RenderState
from .ops import canvas_kernel
from .ops import commands as C
from .ops import executor
from .texture import HitEffectTexture, Texture

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _float_dtype(dtype) -> torch.dtype:
    """torch.float32 / torch.float64 from a torch or numpy float dtype."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
    if dtype not in _NP_DTYPES:
        raise ValueError(f"RenderContext dtype must be float32 or float64, "
                         f"got {dtype}")
    return dtype


def execute(fb, kinds, params, atlas, host_params):
    """Apply a recorded command list to ``fb`` in place, as a flush does.

    fb: (H, W, 4) float32/float64; kinds: (N,) host int32 tensor; params:
    (N, PARAM_W) in fb.dtype on fb's device; atlas: the (AH, AW, 4) atlas
    on fb's device in fb.dtype; host_params: a numpy copy of ``params``,
    for K4's tiles and the hit effects' windows (reading them from the
    card would sync).  Each maximal run of ``KERNEL_KINDS`` is one K4
    call; each hit effect runs over its window.  Spans (``tracing``):
    ``lncr.execute`` around the whole, ``lncr.execute.sample`` around each
    hit effect that has a window, ``lncr.execute.k4`` around each K4
    call."""
    with tracing.span("lncr.execute"):
        kind_list = kinds.tolist()
        n, done = len(kind_list), 0
        for lo, hi in canvas_kernel.kernel_runs(kind_list) + [(n, n)]:
            for i in range(done, lo):   # the hit effects before it
                window = executor.sample_window(host_params[i, 6:10],
                                                fb.shape[1], fb.shape[0])
                if window is not None:
                    with tracing.span("lncr.execute.sample"):
                        executor.render_commands(fb, kind_list[i:i + 1],
                                                 params[i:i + 1], atlas,
                                                 window)
            if hi > lo:
                with tracing.span("lncr.execute.k4"):
                    canvas_kernel.render_span(fb, kinds[lo:hi],
                                              params[lo:hi],
                                              host_params[lo:hi], atlas)
            done = hi
    return fb


class RenderContext:
    # True on recording proxies, whose command buffer is snapshotted each
    # frame (MultiThreadedVideoRenderContextPreparer): a flush in the
    # middle of a frame would execute its queued commands into _fb and
    # drop them from the submitted frame, so a shared texture's refresh
    # must not flush one (see _tex_specific)
    _no_flush_record = False

    def __init__(self, width: int, height: int, enable_alpha: bool,
                 dtype=None, *, device="cuda"):
        self.width = int(width)
        self.height = int(height)
        self.enable_alpha = bool(enable_alpha)
        self.device = interop.as_device(device)
        self._dtype = _float_dtype(dtype or config.default_dtype())
        self._state = RenderState()
        self._cmds = C.CommandBuffer()
        self._store = atlas_mod.get_store(self._dtype, self.device)
        self._seq = 0   # draw counter: shared textures skip re-snapshots
        # Reference allocates uninitialised memory (cpp:15); we zero-init.
        self._fb = torch.zeros((self.height, self.width, 4),
                               dtype=self._dtype, device=self.device)

    # ------------------------------------------------------------------ #
    # recording plumbing
    # ------------------------------------------------------------------ #
    def _record(self, kind, box, specific):
        self._seq += 1
        self._cmds.append(kind, (xf.inverse(self._state.matrix), box,
                                 self._state.color), specific)

    # box modes of a draw's AABB
    _BOX_AABB, _BOX_FAST, _BOX_QUAD, _BOX_FULL = 0, 1, 2, 3

    def _record_draw(self, kind, mode, gx, gy, gw, gh, spec):
        """Record one draw with the command box of ``mode``: in one call
        of the record core (``CommandBuffer.append_draw``) where it is
        built and takes the draw, else in the Python body below
        (``context.py:95-143``, its pure-Python branch), which the core
        equals bit for bit.  ``.native`` and ``.python`` count the draws
        each recorded."""
        st = self._state
        if self._cmds.append_draw(kind, st.matrix, st.color, mode, gx, gy,
                                  gw, gh, spec, float(self.width),
                                  float(self.height)):
            self._seq += 1
            RenderContext._record_draw.native += 1
            return
        if mode == self._BOX_AABB:
            box = xf.aabb(st.matrix, gx, gy, gw, gh, float(self.width),
                          float(self.height))
        elif mode == self._BOX_FAST:
            # DrawTexture fast path (cpp:731-752): float(int(x)) box,
            # unclamped
            box = (float(xf.trunc_clamp(gx)), gx + gw,
                   float(xf.trunc_clamp(gy)), gy + gh)
        elif mode == self._BOX_QUAD:
            # draw_line: transformed-quad AABB superset (corners in
            # spec[0:8]); see draw_line for why this is exact coverage
            cs = [xf.transform_point(st.matrix, spec[i], spec[i + 1])
                  for i in range(0, 8, 2)]
            tx = [c[0] for c in cs]
            ty = [c[1] for c in cs]
            box = (max(0.0, min(float(self.width), math.floor(min(tx)))),
                   max(0.0, min(float(self.width), max(tx) + 1.0)),
                   max(0.0, min(float(self.height), math.floor(min(ty)))),
                   max(0.0, min(float(self.height), max(ty) + 1.0)))
        else:                                   # _BOX_FULL
            box = (0.0, float(self.width), 0.0, float(self.height))
        self._record(kind, box, spec)
        RenderContext._record_draw.python += 1

    _record_draw.native = _record_draw.python = 0

    def flush(self) -> None:
        """Execute all pending draw commands on the context's device,
        updating the framebuffer in place, without a host sync."""
        n = self._cmds.n
        if n == 0:
            return
        kinds, params = self._cmds.snapshot()
        # the params in the framebuffer's dtype, as the JAX flush casts
        # them; the sampling windows are computed from this host copy
        p_host = params.astype(_NP_DTYPES[self._dtype])
        p_dev = torch.from_numpy(p_host)
        if self.device.type == "cuda":
            # from pinned memory the upload is queued without a host sync
            p_dev = p_dev.pin_memory().to(self.device, non_blocking=True)
        execute(self._fb, torch.from_numpy(kinds.copy()), p_dev,
                self._store.atlas, p_host)
        self._cmds.clear()

    # ------------------------------------------------------------------ #
    # transform / state (host-side, cpp:277-309, 386-492, 623-641)
    # ------------------------------------------------------------------ #
    def set_transform(self, a, b, c, d, e, f):
        self._state.set_transform(a, b, c, d, e, f)

    def apply_transform(self, a, b, c, d, e, f):
        self._state.apply_transform(a, b, c, d, e, f)

    def scale(self, sx, sy):
        self._state.scale(sx, sy)

    def translate(self, tx, ty):
        self._state.translate(tx, ty)

    def rotate(self, angle):
        self._state.rotate(angle)

    def rotate_degree(self, deg):
        self.rotate(deg * math.pi / 180)

    def save_state(self):
        self._state.save()

    def restore_state(self):
        return self._state.restore()

    def get_transform(self):
        return tuple(self._state.matrix)

    def get_inverse_transform(self):
        return tuple(xf.inverse(self._state.matrix))

    def set_color_transform(self, r, g, b, a):
        self._state.set_color_transform(r, g, b, a)

    def apply_color_transform(self, r, g, b, a):
        self._state.apply_color_transform(r, g, b, a)

    # ------------------------------------------------------------------ #
    # draw calls (recorded)
    # ------------------------------------------------------------------ #
    def set_color(self, r, g, b, a):
        # SetColor: raw store everywhere, no blend/ct (cpp:643-657).
        self._record_draw(C.KIND_SET_COLOR, self._BOX_FULL, 0.0, 0.0, 0.0,
                          0.0, [r, g, b, a])
        # RGB-mode corruption parity: off the r==g==b==a std::fill fast
        # path (cpp:647-650), SetColor loops SetPixel COLUMN-major, and
        # SetPixel writes buffer[index+3] even when enableAlpha is false
        # (cpp:504-510): pixel (W-1, y)'s alpha lands in pixel (0, y+1)'s
        # R and survives because column 0 was filled first.  Net result:
        # R = a at (0, 1..H-1), recorded as a column-box SET_COLOR with
        # the known G/B fill values.
        if (not self.enable_alpha and self.width > 1 and self.height > 1
                and not (r == g and g == b and b == a)):
            self._record(C.KIND_SET_COLOR,
                         (0.0, 1.0, 1.0, float(self.height)),
                         [a, g, b, a])

    def fill_color(self, r, g, b, a):
        # FillColor: blended full-screen fill with ct (cpp:682-691).
        self._record_draw(C.KIND_FILL, self._BOX_FULL, 0.0, 0.0, 0.0, 0.0,
                          [r, g, b, a])

    def draw_rect(self, x, y, width, height, r, g, b, a):
        if width <= 0 or height <= 0:  # cpp:853
            return
        self._record_draw(C.KIND_RECT, self._BOX_AABB, x, y, width, height,
                          [x, y, x + width, y + height, r, g, b, a])

    def draw_circle(self, x, y, radius, r, g, b, a):
        if radius <= 0:  # cpp:926
            return
        self._record_draw(C.KIND_CIRCLE, self._BOX_AABB, x - radius,
                          y - radius, 2 * radius, 2 * radius,
                          [x, y, radius, 0.0, r, g, b, a])

    def draw_line(self, x0, y0, x1, y1, width, r, g, b, a):
        # Quad construction per cpp:876-906.
        if width <= 0:
            return
        dx = x1 - x0
        dy = y1 - y0
        ln = math.sqrt(dx * dx + dy * dy)
        if ln == 0:
            return
        ux, uy = dx / ln, dy / ln
        vx, vy = -uy, ux
        hw = width / 2
        pts = [x0 - vx * hw, y0 - vy * hw,
               x0 + vx * hw, y0 + vy * hw,
               x1 + vx * hw, y1 + vy * hw,
               x1 - vx * hw, y1 - vy * hw]
        # The reference scans the whole framebuffer (cpp:908-909) and lets
        # the even-odd polygon test decide coverage.  A pixel is covered
        # iff its inverse-mapped point lies in the quad, i.e. iff the pixel
        # lies in the forward-transformed quad, so the transformed
        # corners' AABB (with a 1 px guard on the open ends) is an exact
        # coverage superset.
        self._record_draw(C.KIND_LINE, self._BOX_QUAD, 0.0, 0.0, 0.0, 0.0,
                          pts + [r, g, b, a])

    def draw_vertical_grd(self, x, y, width, height,
                          top_r, top_g, top_b, top_a,
                          bottom_r, bottom_g, bottom_b, bottom_a):
        if width <= 0 or height <= 0:  # cpp:1291
            return
        self._record_draw(C.KIND_VGRD, self._BOX_AABB, x, y, width, height,
                          [x, y, x + width, y + height, y, height,
                           top_r, top_g, top_b, top_a,
                           bottom_r, bottom_g, bottom_b, bottom_a])

    def draw_vertical_mut_grd(self, x, y, width, height, steps):
        # Multi-stop gradient built from N two-stop calls (pybind:272-280).
        for i, (p, s) in enumerate(steps):
            if i == len(steps) - 1:
                break
            np_, ns = steps[i + 1]
            ty = y + height * p
            theight = height * (np_ - p)
            self.draw_vertical_grd(x, ty, width, theight,
                                   s[0], s[1], s[2], s[3],
                                   ns[0], ns[1], ns[2], ns[3])

    def _tex_specific(self, tex, x, y, width, height):
        # a shared texture aliases its owner's live framebuffer; when the
        # owner has drawn since the last snapshot, take a new one
        # (``libnativecpurenderer_tpu/context.py:530-570``)
        owner = tex._shared_ctx
        if owner is not None and tex._shared_seq != owner._seq:
            if owner._no_flush_record and owner._cmds.n > 0:
                # refreshing would flush the owner, consuming its queued
                # frame into its framebuffer
                raise ValueError(
                    "shared texture sampled while its owner (a recording "
                    "proxy) has pending commands: the owner's framebuffer "
                    "is undefined until its batch executes")
            if self._no_flush_record:
                # a proxy cannot flush, and frames pending in a pipeline
                # still read the current texels: give the new ones fresh
                # regions (texture.py recycles the old)
                tex._refresh_shared_new_region()
            else:
                # earlier recorded samples must see the old texels: flush
                # this context first, then update the regions in place
                # (texture._refresh_shared flushes the owner)
                self.flush()
                tex._refresh_shared()
            tex._shared_seq = owner._seq
        # the command references the current regions of the texture it
        # samples (a hit effect's mask's): guard them until it has run
        src = tex._source
        if src._shared_ctx is not None:
            src._note_recording_sampler(self)
        scale_x = tex.width / width
        scale_y = tex.height / height
        ox, oy = tex.region_for(self._store)
        return [x, y, x + width, y + height, scale_x, scale_y,
                float(ox), float(oy), float(tex.width), float(tex.height)]

    def draw_texture(self, tex: Texture, x, y, w, h):
        if w == 0 or h == 0:  # cpp:726
            return
        fast = xf.is_no_transform(self._state.matrix)
        mode = self._BOX_FAST if fast else self._BOX_AABB
        spec = self._tex_specific(tex, x, y, w, h)
        if isinstance(tex, HitEffectTexture):
            spec += [tex.seed, tex.t, *tex.rgb, float(fast)]
            self._record_draw(C.KIND_HITEFFECT, mode, x, y, w, h, spec)
        else:
            # fast path (cpp:731-752): loop range [trunc(x), x+w), raw
            # pixel coords, no membership test
            self._record_draw(C.KIND_TEX_FAST if fast else C.KIND_TEX,
                              mode, x, y, w, h, spec)

    def draw_splitted_texture(self, tex: Texture, x, y, width, height,
                              u_start, u_end, v_start, v_end):
        if width == 0 or height == 0:  # cpp:789
            return
        spec = self._tex_specific(tex, x, y, width, height)
        spec += [u_start, u_end, v_start, v_end]
        self._record_draw(C.KIND_SPLIT_TEX, self._BOX_AABB, x, y, width,
                          height, spec)

    def _pixel_box(self, xi: int, yi: int):
        # single-pixel AABB, clamped like SetPixel's bounds check
        # (cpp:498-501)
        return (float(max(0, min(self.width, xi))),
                float(max(0, min(self.width, xi + 1))),
                float(max(0, min(self.height, yi))),
                float(max(0, min(self.height, yi + 1))))

    def set_pixel(self, x, y, r, g, b, a):
        self._record(C.KIND_SET_PIXEL, self._pixel_box(int(x), int(y)),
                     [float(int(x)), float(int(y)), r, g, b, a])

    def apply_pixel(self, x, y, r, g, b, a):
        self._record(C.KIND_APPLY_PIXEL, self._pixel_box(int(x), int(y)),
                     [float(int(x)), float(int(y)), r, g, b, a])

    # ------------------------------------------------------------------ #
    # readback (device -> host boundary; cpp:52-57, 311-316, 659-680)
    # ------------------------------------------------------------------ #
    @property
    def channels(self) -> int:
        return 4 if self.enable_alpha else 3

    def get_buffer_size(self) -> int:
        return self.width * self.height * self.channels

    def framebuffer(self):
        """The (H, W, 4) framebuffer tensor on the context's device
        (flushes first; the context goes on updating it in place)."""
        self.flush()
        return self._fb

    def numpy_buffer(self) -> np.ndarray:
        """(H, W, channels) float array on the host."""
        self.flush()
        return self._fb[..., : self.channels].cpu().numpy()

    def get_buffer(self) -> list:
        return list(self.numpy_buffer().reshape(-1))

    def uint8_buffer(self) -> np.ndarray:
        """(H, W, channels) uint8 array (quantised on the device,
        cpp:52-57)."""
        self.flush()
        return executor.quantize_u8(self._fb, self.channels).cpu().numpy()

    def get_buffer_as_uint8(self) -> bytearray:
        return bytearray(self.uint8_buffer().tobytes())

    def get_color(self, x, y):
        # GetColor clamps then truncates (cpp:659-680).
        self.flush()
        xi = 0 if x < 0 else (self.width - 1 if x >= self.width else int(x))
        yi = 0 if y < 0 else (self.height - 1 if y >= self.height
                              else int(y))
        px = self._fb[yi, xi].tolist()
        if self.enable_alpha:
            return (px[0], px[1], px[2], px[3])
        # RGB contexts never write out_a; ctypes zero-init -> 0.0 (pybind:261)
        return (px[0], px[1], px[2], 0.0)

    def resize(self, width: int, height: int):
        # ResizeRenderContext reallocates without preserving or
        # initialising content (cpp:39-45); we zero-init.
        self._cmds.clear()
        self.width = int(width)
        self.height = int(height)
        self._fb = torch.zeros((self.height, self.width, 4),
                               dtype=self._dtype, device=self.device)

    # ------------------------------------------------------------------ #
    # texture interop (cpp:362-384)
    # ------------------------------------------------------------------ #
    def as_texure(self) -> Texture:
        """CreateTextureFromRenderContext (copy).  Name kept for parity with
        the reference binding (pybind:282); ``as_texture`` is an alias."""
        self.flush()
        return Texture._from_device_array(self._fb, self.enable_alpha)

    as_texture = as_texure

    def as_texture_shared(self) -> Texture:
        """CreateTextureFromRenderContextShared (cpp:377-384): the
        returned texture aliases this context's live framebuffer, so draws
        issued after sharing are visible through the texture.  The texture
        re-snapshots the framebuffer whenever a draw sampling it is
        recorded after the owner drew (texture._refresh_shared), which
        observes the same states the reference's pointer alias would."""
        self.flush()
        tex = Texture._from_device_array(self._fb, self.enable_alpha)
        tex._shared_ctx = self
        tex._shared_seq = self._seq
        return tex

    def as_pilimg(self):
        from PIL import Image
        mode = "RGBA" if self.enable_alpha else "RGB"
        return Image.frombytes(mode, (self.width, self.height),
                               bytes(self.uint8_buffer().tobytes()))


class MultiThreadedVideoRenderContextPreparer(RenderContext):
    """A recording proxy (the reference's unfinished frame-batching proxy,
    pybind:302-367; ``libnativecpurenderer_tpu/context.py:707-726``).

    Draw calls record as on a ``RenderContext`` (``*args`` and
    ``**kwargs`` are its arguments, ``device="cuda"`` by default), but
    the proxy never flushes them itself: :meth:`end_of_frame` appends the
    frame's ``(kinds, params)`` snapshot to ``frames`` and starts a fresh
    buffer, and a ``BatchedVideoPipeline`` renders the frames.  A shared
    texture it samples is refreshed into fresh atlas regions, so each
    recorded frame keeps the texels of its own record point."""

    _no_flush_record = True

    def __init__(self, v_cap, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.v_cap = v_cap
        self.frames = []

    def end_of_frame(self):
        # the snapshot's views keep their params array, and with it the
        # recycling guard of the regions they sample, alive
        self.frames.append(self._cmds.snapshot())
        self._cmds = C.CommandBuffer()

    def renderer(self):  # parity stub (pybind:362-367)
        pass
