"""Frame pipelines, in PyTorch: recorded 2D frames and meshes -> u8
video frames.

Counterparts of ``BatchedVideoPipeline`` and ``MeshVideoPipeline`` in
``libnativecpurenderer_tpu/pipeline.py:48-320``.  Frames are rendered in
device batches, quantised to u8 on the device and handed to a frame
sink through pinned host memory, one batch behind: batch k reaches the
sink while batch k + 1 renders.  The MP4 encoder of the JAX package
(``VideoCap``, ROADMAP M4) is not ported yet; a sink is any object with
``put_frame_u8(frame (H, W, 4) uint8)`` or, for the mesh kernel's
per-tile layout, ``put_frame_tiled_u8(tiles (NT, P, 4) uint8, w, h, tw,
th)``.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from . import atlas, config, interop, tracing
from .context import _NP_DTYPES, _float_dtype, execute
from .ops import executor, raster3d


class _HostFrames:
    """The u8 frames of batch ``batch`` on their way to the sink: a pinned
    device-to-host copy queued on the current stream and the event that
    marks its end (on the CPU, the frames themselves)."""

    def __init__(self, frames, batch: int) -> None:
        self.batch = batch
        self.done = None
        with tracing.span("lncr.pipeline.copy_out"):
            if frames.device.type == "cuda":
                self.host = torch.empty(frames.shape, dtype=frames.dtype,
                                        pin_memory=True)
                self.host.copy_(frames, non_blocking=True)
                self.done = torch.cuda.Event()
                self.done.record(torch.cuda.current_stream(frames.device))
            else:
                self.host = frames

    def numpy(self) -> np.ndarray:
        with tracing.span("lncr.pipeline.sink_wait", self.batch):
            if self.done is not None:
                self.done.synchronize()
        return self.host.numpy()


class BatchedVideoPipeline:
    """Render recorded 2D frames in batches of ``batch`` on ``device``
    (the card unless the caller asks for ``"cpu"``) and feed them to
    ``cap.put_frame_u8``.

        rec = MultiThreadedVideoRenderContextPreparer(None, W, H, True)
        pipe = BatchedVideoPipeline(sink, W, H, batch=16)
        for each frame:
            record on rec ...
            pipe.submit(*rec._cmds.snapshot()); rec._cmds.clear()
        pipe.finish()

    :meth:`submit` copies a frame's ``(kinds, params)`` (a recorded
    command list, ``ops/commands.py``).  Each frame starts from a copy of
    ``fb0`` ((H, W, 4), zeros by default; e.g. a pre-composited static
    background) and runs through ``context.execute``, the flush of a
    ``RenderContext``: K4 for each run of arithmetic commands and texture
    blits, torch ops for each hit effect, reading the atlas store of
    (``dtype``, ``device``) as it stands at the flush.  Every upload and every frame
    goes on the device's current stream, so a frame reads each atlas
    region as the uploads queued before its batch left it.  The JAX
    package's XLA routes (scan buckets, fused and vmapped programs) have
    no counterpart.  Without a card the default ``device="cuda"``
    raises."""

    def __init__(self, cap, width: int, height: int, batch: int = 16,
                 dtype=None, fb0=None, *, device="cuda"):
        self.cap = cap
        self.width = int(width)
        self.height = int(height)
        self.batch = batch
        self.device = interop.as_device(device)
        self._dtype = _float_dtype(dtype or config.default_dtype())
        self._store = atlas.get_store(self._dtype, self.device)
        shape = (self.height, self.width, 4)
        if fb0 is None:
            self._fb0 = torch.zeros(shape, dtype=self._dtype,
                                    device=self.device)
        else:
            self._fb0 = torch.as_tensor(fb0).to(self.device, self._dtype)
            if tuple(self._fb0.shape) != shape:
                raise ValueError(f"fb0 must be {shape}, got "
                                 f"{tuple(self._fb0.shape)}")
        self._pending: list = []
        self._inflight = None
        self._flushes = 0               # the batch id of the next flush
        atlas.register_pipeline(self)   # shared-texture region fences

    def submit(self, kinds, params) -> None:
        self._pending.append((np.array(kinds, np.int32),
                              np.array(params, np.float64)))
        if len(self._pending) >= self.batch:
            self.flush()

    def flush(self) -> None:
        """Render the pending frames, start their copy to the host, and
        hand the previous batch to the sink."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        b, self._flushes = self._flushes, self._flushes + 1
        with tracing.span("lncr.pipeline.flush", b):
            with tracing.span("lncr.pipeline.upload"):
                # the params in the frames' dtype, as RenderContext.flush
                # casts them; one upload for the batch, queued from pinned
                # memory
                host = [p.astype(_NP_DTYPES[self._dtype])
                        for _, p in pending]
                p_dev = torch.from_numpy(np.concatenate(host))
                if self.device.type == "cuda":
                    p_dev = p_dev.pin_memory().to(self.device,
                                                  non_blocking=True)
            frames = torch.empty((len(pending), self.height, self.width, 4),
                                 dtype=torch.uint8, device=self.device)
            store_atlas = self._store.atlas      # _grow replaces the tensor
            lo = 0
            for i, ((kinds, _), ph) in enumerate(zip(pending, host)):
                fb = self._fb0.clone()
                execute(fb, torch.from_numpy(kinds), p_dev[lo:lo + len(ph)],
                        store_atlas, ph)
                frames[i] = executor.quantize_u8(fb)
                lo += len(ph)
            out = _HostFrames(frames, b)
            atlas.dispatch_fence(self)
            self._drain()
            self._inflight = out

    def _drain(self) -> None:
        if self._inflight is None:
            return
        inflight = self._inflight
        frames = inflight.numpy()
        self._inflight = None
        with tracing.span("lncr.pipeline.deliver", inflight.batch):
            for fr in frames:
                self.cap.put_frame_u8(fr)

    def finish(self) -> None:
        self.flush()
        self._drain()


class MeshVideoPipeline:
    """Render submitted MVPs in batches of ``batch`` frames on ``device``
    (the card unless the caller asks for ``"cpu"``) and feed them to
    ``cap``, in one of three modes: Gouraud when ``colors`` is given,
    textured when ``uvs`` and ``tex_u8`` are, blended when ``uvs``,
    ``tex_u8`` and ``blend=True`` are (exactly one of the three).  The
    blended mode draws a batch of textured quads back to front, alpha
    blended and z-tested against ``opaque_depth`` ((H, W) float32, the
    depth of an opaque layer drawn before them; uploaded once, default
    1), BASELINE config 2 (``raster3d.render_blended_u8_loop``).

        pipe = MeshVideoPipeline(sink, W, H, verts, faces, colors=cols)
        # or uvs=uvs, tex_u8=tex ((th, tw, 4) uint8)
        # or uvs=uvs, tex_u8=tex, blend=True, opaque_depth=depth
        for mvp in mvps: pipe.submit(mvp)
        pipe.finish()

    Frames go to ``cap.put_frame_tiled_u8`` when the sink has it (and
    ``tiled`` is not False), else to ``cap.put_frame_u8``.  A batch's
    render and its copy to pinned host memory are queued without a host
    sync; the host waits for that copy only after it has queued the next
    batch, so frames of batch k reach the sink while batch k + 1 renders.
    Each batch's
    overflow flag stays on the device until :meth:`finish`, which raises
    ``ValueError`` if any frame overflowed.  ``render_kw`` are the
    keyword arguments of the mode's loop entry, ``render_gouraud_u8_loop``,
    ``render_textured_u8_loop`` or ``render_blended_u8_loop`` (tile
    shape, capacity, spans, bg, and opaque or perspective_correct,
    z_clip); others raise ``TypeError`` here.  Each batch is one
    prep pass, one kernel launch and one detile.  The mesh is rendered in
    float32, whatever ``config.default_dtype()`` is, as in the JAX
    pipeline.  Without a
    card the default ``device="cuda"`` raises."""

    def __init__(self, cap, width: int, height: int, verts, faces,
                 colors=None, uvs=None, tex_u8=None, batch: int = 16,
                 tiled=None, *, device="cuda", blend: bool = False,
                 opaque_depth=None, **render_kw):
        textured = uvs is not None or tex_u8 is not None
        if (colors is not None) == textured or \
                (uvs is None) != (tex_u8 is None):
            raise ValueError("exactly one of colors=, (uvs=, tex_u8=) and "
                             "(uvs=, tex_u8=, blend=True)")
        if opaque_depth is not None and not blend:
            raise ValueError("opaque_depth= is the blended mode's "
                             "(blend=True)")
        if blend and not textured:
            raise ValueError("blend=True draws textured quads: pass uvs= "
                             "and tex_u8=, not colors=")
        self._render = (raster3d.render_blended_u8_loop if blend
                        else raster3d.render_textured_u8_loop if textured
                        else raster3d.render_gouraud_u8_loop)
        inspect.signature(self._render).bind_partial(**render_kw)
        if blend and ("pre" in render_kw or "opaque_depth" in render_kw):
            raise TypeError("the pipeline makes the blended mode's pre= "
                            "and takes opaque_depth= itself")
        self.cap = cap
        self.width = width
        self.height = height
        self.batch = batch
        self.device = interop.as_device(device)
        # float32 whatever config.default_dtype() says, as the JAX
        # pipeline casts its mesh (pipeline.py:251-257 there)
        if textured:
            self._mesh = interop.textured_mesh_to_torch(
                verts, faces, uvs, tex_u8, self.device, torch.float32)
        else:
            self._mesh = interop.mesh_to_torch(verts, faces, colors,
                                               self.device, torch.float32)
        has_tiled = hasattr(cap, "put_frame_tiled_u8")
        self._tiled = has_tiled if tiled is None else (bool(tiled)
                                                       and has_tiled)
        kw = dict(render_kw)
        if blend:
            # frame-invariant: the face rows, the packed texels, the
            # quads' centres, and the opaque layer's depth
            kw["pre"] = raster3d.blend_pre(*self._mesh)
            od = torch.as_tensor(np.ones((height, width), np.float32)
                                 if opaque_depth is None else opaque_depth)
            if tuple(od.shape) != (height, width):
                raise ValueError(f"opaque_depth must be ({height}, "
                                 f"{width}), got {tuple(od.shape)}")
            kw["opaque_depth"] = od.to(self.device,
                                       torch.float32).contiguous()
        kw.setdefault("tile_w", 32)
        kw.setdefault("tile_h", 32)
        self._tile_w = kw["tile_w"]
        self._tile_h = kw["tile_h"]
        self._kw = kw
        self._pending: list = []
        self._inflight = None     # _HostFrames of the last batch
        self._ovf: list = []      # per-batch overflow flags (device)
        self._flushes = 0         # the batch id of the next flush

    def submit(self, mvp) -> None:
        self._pending.append(np.asarray(mvp, np.float32))
        if len(self._pending) >= self.batch:
            self.flush()

    def flush(self) -> None:
        """Render the pending frames, start their copy to the host, and
        hand the previous batch to the sink."""
        if not self._pending:
            return
        b, self._flushes = self._flushes, self._flushes + 1
        with tracing.span("lncr.pipeline.flush", b):
            with tracing.span("lncr.pipeline.upload"):
                mvps = torch.from_numpy(np.stack(self._pending))
                self._pending.clear()
                if self.device.type == "cuda":
                    # from pinned memory the upload is queued without a
                    # host sync
                    mvps = mvps.pin_memory().to(self.device,
                                                non_blocking=True)
            frames, ovf = self._render(*self._mesh, self.width, self.height,
                                       mvps, tiled=self._tiled, **self._kw)
            self._ovf.append(ovf)
            out = _HostFrames(frames, b)
            self._drain()
            self._inflight = out

    def _drain(self) -> None:
        if self._inflight is None:
            return
        inflight = self._inflight
        frames = inflight.numpy()
        self._inflight = None
        with tracing.span("lncr.pipeline.deliver", inflight.batch):
            for fr in frames:
                if self._tiled:
                    self.cap.put_frame_tiled_u8(fr, self.width, self.height,
                                                self._tile_w, self._tile_h)
                else:
                    self.cap.put_frame_u8(fr)

    def finish(self) -> None:
        self.flush()
        self._drain()
        if self._ovf and bool(torch.stack(self._ovf).any()):
            raise ValueError(
                "mesh raster bin/span overflow — raise capacity/span_x/"
                "span_y (see raster3d.bin_triangles_flat)")
