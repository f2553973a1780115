"""The blended quad batch -> u8 video system, BASELINE config 2: the
port's ``pipeline.MeshVideoPipeline`` in its blended mode (``blend=True``:
textured quads drawn back to front, alpha blended and z-tested against a
static opaque depth), fed one model-view-projection matrix a frame by a
``camera_orbit`` mix, its frames detiled on the device and handed to the
benchmark's sink by ``put_frame_u8``.

Set-up first reads the port's blend counters (``System.counters``: a
port without the blended mode cannot run the cell, and fails there,
before anything is made), then builds the quads and the sprite from the
seed and the opaque layer's depth ramp from the fragment depths of the
run's first frame (``inputs``).  A frame's whole path lies under
``submit``/``finish``: the upload of the batch's matrices, the per-frame
draw order, projection, binning (each triangle's draw step as its id),
sort and table, K7, the detile, the u8 frames' pinned copy, one batch
behind.  The reference (``references/quad_blend``) draws the same quads
under the same matrix with the blend in float64.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import sys
from unittest import mock

import numpy as np
import torch

from ..generators import camera_orbit
from ..harness import traffic as traffic_mod
from ..references import quad_blend as ref

LIBRARY = "tile_blend"           # the library whose kernel K7 is
REPLAY_BATCHES = 2               # batches of the profiled inputs replayed
HALF_VIEWS = 4                   # views of each orbit half the log reads
SPANS = ("lncr.raster3d.prep", "lncr.raster3d.blend_order",
         "lncr.raster3d.edges", "lncr.raster3d.bin", "lncr.raster3d.table",
         "lncr.pipeline.flush")


def inputs(config: dict, mix: dict, seed: int, device) -> dict:
    """The cell's inputs from the seed: the quads of ``scenes/<scene>``
    and its sprite (verts, uvs float32, faces, tex u8: NumPy), the
    generator's unrotated camera (``base``), and the opaque layer's depth
    (``opaque_depth``, (H, W) float32), the scene's ramp over the
    reference's depths of the covered fragments of the run's first frame
    (``generator.frame(0)``), counted on ``device``."""
    scene = importlib.import_module(f"bench_torch.scenes.{config['scene']}")
    w, h = config["width"], config["height"]
    verts, faces, uvs = scene.build(config["quads"], seed)
    made = {"verts": verts.astype(np.float32), "faces": faces,
            "uvs": uvs.astype(np.float32),
            "tex": scene.sprite(config["texture"], seed)}
    gen = traffic_mod.generator(mix, config, seed)
    depths = ref.fragment_depths(_tensors(made, device),
                                 torch.from_numpy(gen.frame(0)), w, h)
    made["opaque_depth"] = scene.opaque_ramp(depths, w, h)
    made["base"] = gen.base
    return made


def _tensors(made: dict, device) -> dict:
    """The reference's scene dict of ``inputs``' arrays on ``device``."""
    return {"verts": torch.from_numpy(made["verts"]).to(device),
            "faces": torch.from_numpy(made["faces"]).to(device),
            "uvs": torch.from_numpy(made["uvs"]).to(device),
            "tex": torch.from_numpy(made["tex"]).to(device),
            "bg": torch.zeros(4, device=device)}


class _NoSink:
    def put_frame_u8(self, frame) -> None:
        pass


class System:
    record = None                # a frame is its matrix: nothing recorded

    def __init__(self, config: dict, mix: dict, seed: int, device, sink):
        self.counters()
        made = inputs(config, mix, seed, device)
        self.width, self.height = config["width"], config["height"]
        self.verts, self.faces, self.uvs = (made["verts"], made["faces"],
                                            made["uvs"])
        self.tex, self.opaque_depth = made["tex"], made["opaque_depth"]
        self.base = made["base"]
        self.kw = {k: config[k] for k in ("tile_w", "tile_h", "capacity",
                                          "span_x", "span_y")}
        self.batch = config["batch"]
        self.device = device
        self.pipe = self._pipeline(sink)

    def _pipeline(self, sink):
        from libnativecpurenderer_tpu_torch import MeshVideoPipeline
        return MeshVideoPipeline(
            sink, self.width, self.height, self.verts, self.faces,
            uvs=self.uvs, tex_u8=self.tex, blend=True,
            opaque_depth=self.opaque_depth, batch=self.batch,
            device=self.device, **self.kw)

    @staticmethod
    def counters() -> dict:
        """The port's blend counters by name; raises ``RuntimeError``
        naming those it lacks."""
        from libnativecpurenderer_tpu_torch.ops import raster3d, tile_raster
        where = {
            "prepare_blended_frame.calls": (
                getattr(raster3d, "prepare_blended_frame", None), "calls"),
            "prepare_blended_frame.frames": (
                getattr(raster3d, "prepare_blended_frame", None), "frames"),
            "blend_order.quads": (getattr(raster3d, "blend_order", None),
                                  "quads"),
            "raster_tiles_blend_u8.launches": (
                getattr(tile_raster, "raster_tiles_blend_u8", None),
                "launches")}
        missing = [k for k, (f, a) in where.items() if not hasattr(f, a)]
        if missing:
            raise RuntimeError(f"the port lacks the blended mesh mode's "
                               f"{missing}, which this cell runs and its "
                               f"traced run reads")
        return {k: getattr(f, a) for k, (f, a) in where.items()}

    def submit(self, mvp) -> None:
        self.pipe.submit(mvp)

    def finish(self) -> None:
        self.pipe.finish()

    def close(self) -> None:
        self.pipe = None

    def _scene(self, device) -> dict:
        return _tensors({"verts": self.verts, "faces": self.faces,
                         "uvs": self.uvs, "tex": self.tex}, device)

    def reference(self, mvp, device, control=False):
        """The reference's u8 frame of one frame's matrix (the control's
        with ``control``: in bfloat16)."""
        dtype = torch.bfloat16 if control else torch.float64
        return ref.render(self._scene(device), torch.from_numpy(mvp),
                          self.width, self.height,
                          torch.from_numpy(self.opaque_depth).to(device),
                          dtype=dtype)

    def work(self, inputs, device) -> dict:
        """The least work of these frames, counted from their inputs by
        the reference (``rooflines/tile_blend``: covered and drawn
        fragments, the bytes read and written once), and a replay's span
        totals and counters (under ``blend_replay``): a new pipeline on
        the device, one warm batch, then ``REPLAY_BATCHES`` batches of
        these inputs with tracing on (ranges off), logged on standard
        error with the z test's rejected share, of these frames and of
        each half of the orbit."""
        scene = self._scene(device)
        od = torch.from_numpy(self.opaque_depth).to(device)
        covered = drawn = 0
        for m in inputs:
            c, d = ref.fragments(scene, torch.from_numpy(m), self.width,
                                 self.height, od)
            covered += c
            drawn += d
        counts = {"frames": len(inputs), "covered": covered, "drawn": drawn,
                  "pixels": len(inputs) * self.width * self.height,
                  "shared_bytes": (self.tex.nbytes + self.opaque_depth.nbytes
                                   + self.verts.nbytes + self.uvs.nbytes
                                   + self.faces.shape[0] * 3 * 4),
                  "frame_bytes": 16 * 4}
        replay = self._replay(inputs)
        replay["z_rejected_share"] = (1.0 - drawn / covered if covered
                                      else None)
        replay["z_rejected_by_half"] = self._rejected_by_half(scene, od)
        print(f"quad replay: {json.dumps(replay)}", file=sys.stderr,
              flush=True)
        return {"tile_blend": counts, "blend_replay": replay}

    def _rejected_by_half(self, scene, od) -> dict:
        """The z test's rejected share of the covered fragments over each
        half of the orbit, the camera in front of the quads (cos > 0 of
        its angle) or behind them, from ``HALF_VIEWS`` views of each
        evenly spaced."""
        n = 2 * HALF_VIEWS
        tally = {"front": [0, 0], "behind": [0, 0]}
        for k in range(n):
            angle = (k + 0.5) * 2 * math.pi / n
            m = (self.base @ camera_orbit.rotation_y(angle)).astype(
                np.float32)
            c, d = ref.fragments(scene, torch.from_numpy(m), self.width,
                                 self.height, od)
            half = tally["front" if math.cos(angle) > 0 else "behind"]
            half[0] += c
            half[1] += d
        return {k: 1.0 - d / c if c else None for k, (c, d) in tally.items()}

    def _replay(self, inputs) -> dict:
        from libnativecpurenderer_tpu_torch import tracing
        pipe = self._pipeline(_NoSink())
        for m in inputs[:self.batch]:
            pipe.submit(m)
        pipe.finish()
        before = self.counters()
        frames = max(REPLAY_BATCHES * self.batch, len(inputs))
        tracing.reset()
        tracing.ranges(False)
        tracing.enable(True)
        try:
            for i in range(frames):
                pipe.submit(inputs[i % len(inputs)])
            pipe.finish()
            totals = tracing.totals()
            after = self.counters()
        finally:
            tracing.enable(False)
            tracing.reset()
        return {"frames": frames,
                "spans": {k: v for k, v in totals.items() if k in SPANS},
                "counters": {k: after[k] - before[k] for k in after}}


def fault(kind: str):
    """``faults.KINDS``' ``kind`` planted in the blend's loop entry: a
    batch's later frames repeat its first (``unchanged``), its second
    half zero (``half``), or a 32x32 block of every frame flipped
    (``altered``)."""
    from libnativecpurenderer_tpu_torch.ops import raster3d
    real = raster3d.render_blended_u8_loop

    def fake(*a, **kw):
        frames, ovf = real(*a, **kw)
        frames = frames.clone()
        if kind == "unchanged":
            frames[1:] = frames[:1]
        elif kind == "half":
            frames[frames.shape[0] // 2:] = 0
        else:
            frames[:, 8:40, 8:40] ^= 0x55
        return frames, ovf
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(raster3d, "render_blended_u8_loop",
                                          fake))
    return stack


def small(cell, **variant):
    """The cell cut for the CPU tests: 64 quads at 160x96, batch 4, a
    32x32 sprite; the limits are the cell's.  Returns the configuration,
    mix and limits, and the seconds of a CPU window that holds two
    batches (a batch takes about 0.1 s there)."""
    if variant:
        raise ValueError(f"the blend cell has no variant {sorted(variant)}")
    config = dict(cell.config, width=160, height=96, batch=4, quads=64,
                  texture=[32, 32])
    return config, cell.mix, cell.limits, 1.0
