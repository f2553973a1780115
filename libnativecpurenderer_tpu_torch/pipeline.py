"""Mesh -> video frame pipeline (Gouraud and textured), in PyTorch.

Counterpart of ``MeshVideoPipeline`` in
``libnativecpurenderer_tpu/pipeline.py:219-320``: MVPs are submitted per
frame, rendered in device batches by ``raster3d.render_gouraud_u8_loop``
or ``raster3d.render_textured_u8_loop``, and handed to a frame sink.  The
MP4 encoder of the JAX package (``VideoCap``, ROADMAP M4) is not ported
yet; a sink is any object with
``put_frame_u8(frame (H, W, 4) uint8)`` or, for the kernel's per-tile
layout, ``put_frame_tiled_u8(tiles (NT, P, 4) uint8, w, h, tw, th)``.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from . import interop
from .ops import raster3d


class MeshVideoPipeline:
    """Render submitted MVPs in batches of ``batch`` frames on ``device``
    (the card unless the caller asks for ``"cpu"``) and feed them to
    ``cap``.  Gouraud when ``colors`` is given, textured when ``uvs`` and
    ``tex_u8`` are (exactly one of the two).

        pipe = MeshVideoPipeline(sink, W, H, verts, faces, colors=cols)
        # or uvs=uvs, tex_u8=tex ((th, tw, 4) uint8)
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
    keyword arguments of ``render_gouraud_u8_loop`` or
    ``render_textured_u8_loop`` (tile shape, capacity, spans, bg, and
    opaque or perspective_correct, z_clip); others raise ``TypeError``
    here.  The mesh is rendered in float32, whatever
    ``config.default_dtype()`` is, as in the JAX pipeline.  Without a
    card the default ``device="cuda"`` raises."""

    def __init__(self, cap, width: int, height: int, verts, faces,
                 colors=None, uvs=None, tex_u8=None, batch: int = 16,
                 tiled=None, *, device="cuda", **render_kw):
        textured = uvs is not None or tex_u8 is not None
        if (colors is not None) == textured or \
                (uvs is None) != (tex_u8 is None):
            raise ValueError("exactly one of colors= and (uvs=, tex_u8=)")
        self._render = (raster3d.render_textured_u8_loop if textured
                        else raster3d.render_gouraud_u8_loop)
        inspect.signature(self._render).bind_partial(**render_kw)
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
        kw.setdefault("tile_w", 32)
        kw.setdefault("tile_h", 32)
        self._tile_w = kw["tile_w"]
        self._tile_h = kw["tile_h"]
        self._kw = kw
        self._pending: list = []
        self._inflight = None     # (host frames, copy-done event, n)
        self._ovf: list = []      # per-batch overflow flags (device)

    def submit(self, mvp) -> None:
        self._pending.append(np.asarray(mvp, np.float32))
        if len(self._pending) >= self.batch:
            self.flush()

    def flush(self) -> None:
        """Render the pending frames, start their copy to the host, and
        hand the previous batch to the sink."""
        if not self._pending:
            return
        mvps = torch.from_numpy(np.stack(self._pending))
        self._pending.clear()
        cuda = self.device.type == "cuda"
        if cuda:
            # from pinned memory the upload is queued without a host sync
            mvps = mvps.pin_memory().to(self.device, non_blocking=True)
        frames, ovf = self._render(*self._mesh, self.width, self.height,
                                   mvps, tiled=self._tiled, **self._kw)
        self._ovf.append(ovf)
        done = None
        if cuda:
            host = torch.empty(frames.shape, dtype=frames.dtype,
                               pin_memory=True)
            host.copy_(frames, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        else:
            host = frames
        self._drain()
        self._inflight = (host, done, int(mvps.shape[0]))

    def _drain(self) -> None:
        if self._inflight is None:
            return
        host, done, n = self._inflight
        self._inflight = None
        if done is not None:
            done.synchronize()
        frames = host.numpy()
        for i in range(n):
            if self._tiled:
                self.cap.put_frame_tiled_u8(frames[i], self.width,
                                            self.height, self._tile_w,
                                            self._tile_h)
            else:
                self.cap.put_frame_u8(frames[i])

    def finish(self) -> None:
        self.flush()
        self._drain()
        if self._ovf and bool(torch.stack(self._ovf).any()):
            raise ValueError(
                "mesh raster bin/span overflow — raise capacity/span_x/"
                "span_y (see raster3d.bin_triangles_flat)")
