"""The chart frame -> u8 video system, as the chart renderer runs it: the
mix's static calls drawn once on a ``RenderContext`` of the port into the
frames' initial framebuffer; then each frame's calls recorded on the
port's ``MultiThreadedVideoRenderContextPreparer`` (the record layer) and
``BatchedVideoPipeline.submit(*rec._cmds.snapshot())``: the params' cast
and upload a batch, ``fb0.clone()``, ``context.execute`` (K4 for each
run of arithmetic commands, the sampling ops for each texture command),
``quantize_u8`` and the pinned copy, one batch behind.

The reference (``references/canvas``) replays the static and the frame's
calls on the same texels in float64.
"""

from __future__ import annotations

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
        the reference: the pixels each arithmetic draw covers, by call,
        and the pixels of their union (each read and written once), keyed
        by the roofline's layer."""
        covered_px: dict = {}
        calls: dict = {}
        union = 0
        for frame in inputs:
            cv = canvas_ref.Canvas(self.width, self.height, device,
                                   cover=True)
            cv.run(frame, dict.fromkeys(self.texels))
            mark = torch.zeros((self.height, self.width), dtype=torch.bool,
                               device=device)
            for call, (x0, x1, y0, y1), m in cv.covered:
                calls[call] = calls.get(call, 0) + 1
                covered_px[call] = covered_px.get(call, 0) + int(m.sum())
                mark[y0:y1, x0:x1] |= m
            union += int(mark.sum())
        return {"canvas_span": {"frames": len(inputs),
                                "covered_px": covered_px,
                                "union_px": union, "calls": calls,
                                "px_bytes": self.px_bytes}}
