"""Mesh -> video frame pipeline (Gouraud), in PyTorch.

Counterpart of ``MeshVideoPipeline`` in
``libnativecpurenderer_tpu/pipeline.py:219-320``: MVPs are submitted per
frame, rendered in device batches by ``raster3d.render_gouraud_u8_loop``,
and handed to a frame sink.  The MP4 encoder of the JAX package
(``VideoCap``, ROADMAP M4) is not ported yet; a sink is any object with
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
    and feed them to ``cap``.

        pipe = MeshVideoPipeline(sink, W, H, verts, faces, colors=cols,
                                 device="cuda")
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
    keyword arguments of ``render_gouraud_u8_loop`` (tile shape,
    capacity, spans, bg, opaque, z_clip); others raise ``TypeError``
    here."""

    def __init__(self, cap, width: int, height: int, verts, faces,
                 colors=None, uvs=None, tex_u8=None, batch: int = 16,
                 tiled=None, *, device, **render_kw):
        if uvs is not None or tex_u8 is not None:
            raise NotImplementedError(
                "textured mesh video (uvs=/tex_u8=) is not ported yet "
                "(ROADMAP M3)")
        if colors is None:
            raise ValueError("colors= is required")
        inspect.signature(raster3d.render_gouraud_u8_loop).bind_partial(
            **render_kw)
        self.cap = cap
        self.width = width
        self.height = height
        self.batch = batch
        self.device = interop.as_device(device)
        self._verts, self._faces, self._colors = interop.mesh_to_torch(
            verts, faces, colors, self.device)
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
        frames, ovf = raster3d.render_gouraud_u8_loop(
            self._verts, self._faces, self._colors, self.width,
            self.height, mvps, tiled=self._tiled, **self._kw)
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
