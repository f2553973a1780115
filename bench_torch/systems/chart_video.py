"""The chart frame -> u8 video system, as the chart renderer runs it: the
mix's static calls drawn once on a ``RenderContext`` of the port into the
frames' initial framebuffer; then each frame's calls recorded on the
port's ``MultiThreadedVideoRenderContextPreparer`` (the record layer) and
``BatchedVideoPipeline.submit(*rec._cmds.snapshot())``: the params' cast
and upload a batch, ``fb0.clone()``, ``context.execute`` (K4 for each
run of arithmetic draws and texture blits, the executor's sampling ops
for a hit effect only), ``quantize_u8`` and the pinned copy, one batch
behind.

The reference (``references/canvas``) replays the static and the frame's
calls on the same texels in float64.
"""

from __future__ import annotations

from unittest import mock

import torch

from ..harness import traffic as traffic_mod
from ..references import canvas as canvas_ref

LIBRARY = "canvas_span"          # the library whose kernel K4 is


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device, sink):
        from libnativecpurenderer_tpu_torch import (
            BatchedVideoPipeline, MultiThreadedVideoRenderContextPreparer,
            RenderContext, Texture, config as port_config)
        self.width, self.height = config["width"], config["height"]
        dtype = getattr(torch, config["dtype"])
        if port_config.default_dtype() != dtype:
            raise ValueError(f"the port's default dtype is "
                             f"{port_config.default_dtype()}, the "
                             f"configuration states {dtype}")
        self.texels = self._texels(mix["textures"], seed, device, dtype)
        self.textures = {n: Texture._from_array(t, mix["textures"][n]["alpha"])
                         for n, t in self.texels.items()}
        self.static = mix["static_calls"]
        ctx = RenderContext(self.width, self.height, True, device=device)
        self._replay(ctx, self.static)
        ctx.flush()
        fb0 = ctx.framebuffer().clone()
        self.rec = MultiThreadedVideoRenderContextPreparer(
            None, self.width, self.height, True, device=device)
        self.px_bytes = fb0[0, 0].nbytes          # an RGBA pixel
        self.batch = config["batch"]
        self.pipe = BatchedVideoPipeline(sink, self.width, self.height,
                                         self.batch, dtype, fb0,
                                         device=device)

    @staticmethod
    def _texels(spec: dict, seed: int, device, dtype) -> dict:
        """Every texture's (h, w, 4) texels from the seed, in one call on
        the device; a texture without alpha has alpha 1."""
        shapes = {n: (t["height"], t["width"], 4)
                  for n, t in sorted(spec.items())}
        sizes = [h * w * c for h, w, c in shapes.values()]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(traffic_mod.seed_rng(seed, 3).integers(1 << 62)))
        flat = torch.rand(sum(sizes), generator=gen, device=device,
                          dtype=dtype)
        out = {n: part.view(shape) for (n, shape), part in
               zip(shapes.items(), flat.split(sizes))}
        for n, t in out.items():
            if not spec[n]["alpha"]:
                t[..., 3] = 1
        return out

    def _replay(self, ctx, calls) -> None:
        tex = self.textures
        for name, *args in calls:
            getattr(ctx, name)(*[tex[a] if isinstance(a, str) else a
                                 for a in args])

    def record(self, calls) -> None:
        self._replay(self.rec, calls)

    def submit(self, calls) -> None:
        self.pipe.submit(*self.rec._cmds.snapshot())
        self.rec._cmds.clear()

    def finish(self) -> None:
        self.pipe.finish()

    def close(self) -> None:
        self.pipe = self.rec = self.textures = None

    def reference(self, calls, device, control=False):
        """The reference's u8 frame of one frame's calls (the control's
        with ``control``: in bfloat16)."""
        dtype = torch.bfloat16 if control else torch.float64
        texels = {n: t.to(device) for n, t in self.texels.items()}
        return canvas_ref.render(self.static, calls, texels, self.width,
                                 self.height, device, dtype)

    def work(self, inputs, device) -> dict:
        """What K4 must do for these frames, counted from their calls by
        the reference: the pixels each draw and blit covers, by call, the
        pixels of their union (each read and written once) and the bytes
        of the texels the blits read (each once a frame), keyed by the
        roofline's layer."""
        covered_px: dict = {}
        calls: dict = {}
        union = texel_bytes = 0
        for frame in inputs:
            cv = canvas_ref.Canvas(self.width, self.height, device,
                                   cover=True)
            cv.run(frame, self.texels)
            mark = torch.zeros((self.height, self.width), dtype=torch.bool,
                               device=device)
            read: dict = {}
            for call, (x0, x1, y0, y1), m, texels in cv.covered:
                calls[call] = calls.get(call, 0) + 1
                covered_px[call] = covered_px.get(call, 0) + int(m.sum())
                mark[y0:y1, x0:x1] |= m
                if texels is not None:
                    tex, idx = texels
                    if id(tex) not in read:
                        read[id(tex)] = (tex, torch.zeros(
                            tex.shape[0] * tex.shape[1], dtype=torch.bool,
                            device=device))
                    read[id(tex)][1][idx] = True
            union += int(mark.sum())
            texel_bytes += sum(int(seen.sum()) * tex[0, 0].nbytes
                               for tex, seen in read.values())
        return {"canvas_span": {"frames": len(inputs),
                                "covered_px": covered_px,
                                "union_px": union, "calls": calls,
                                "px_bytes": self.px_bytes,
                                "texel_bytes": texel_bytes}}


def fault(kind: str):
    """``faults.KINDS``' ``kind`` planted in the frame pipeline: a frame
    never executed, so it is its initial framebuffer (``unchanged``);
    every other frame not executed (``half``); or a 32x32 block of every
    frame's u8 bytes flipped (``altered``)."""
    from libnativecpurenderer_tpu_torch import pipeline
    from libnativecpurenderer_tpu_torch.ops import executor
    if kind == "unchanged":
        return mock.patch.object(pipeline, "execute", lambda *a, **kw: None)
    if kind == "half":
        real, n = pipeline.execute, [0]

        def every_other(*a, **kw):
            n[0] += 1
            if n[0] % 2:
                real(*a, **kw)
        return mock.patch.object(pipeline, "execute", every_other)
    real_q = executor.quantize_u8

    def altered(fb, *a, **kw):
        u8 = real_q(fb, *a, **kw).clone()
        u8[8:40, 8:40] ^= 0x55
        return u8
    return mock.patch.object(executor, "quantize_u8", altered)


SMALL_W, SMALL_H = 160, 96
SMALL_SCALE = 1 / 12                # the chart's calls are drawn at 1080p
SMALL_FRAMES = 12


def _wrap(calls):
    return [["save_state"], ["scale", SMALL_SCALE, SMALL_SCALE], *calls,
            ["restore_state"]]


def small(cell, **variant):
    """The cell cut for the CPU tests: 160x96 at batch 2, the static and
    every frame's calls drawn under a scale of 1/12 (wrapped in
    ``save_state``, ``scale``, ``restore_state``), 12 frames from the
    middle of the chart, where notes are on screen, and the textures
    clipped to the frame.  The chart has no variant.  Returns the
    configuration, mix and limits, and the seconds of a CPU window."""
    if variant:
        raise ValueError(f"the chart cell has no variant {sorted(variant)}")
    config = dict(cell.config, width=SMALL_W, height=SMALL_H, batch=2)
    lines = cell.mix["lines"]
    mid = len(lines) // 2
    mix = dict(cell.mix, static_calls=_wrap(cell.mix["static_calls"]),
               lines=[_wrap(f) for f in lines[mid:mid + SMALL_FRAMES]])
    mix["textures"] = {
        n: dict(t, height=min(t["height"], SMALL_H),
                width=min(t["width"], SMALL_W))
        for n, t in cell.mix["textures"].items()}
    return config, mix, cell.limits, 1.0
