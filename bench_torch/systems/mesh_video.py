"""The mesh -> u8 video system: ``pipeline.MeshVideoPipeline`` of the
port, fed one model-view-projection matrix a frame by a ``camera_orbit``
mix, its frames detiled on the device and handed to the benchmark's sink
by ``put_frame_u8``.

A frame's whole path lies under ``submit``/``finish``: the upload of the
batch's matrices, projection, binning, sort and table, K1 (Gouraud) or K3
(textured), the detile, the u8 frames' pinned copy, one batch behind.
The reference (``references/mesh_raster``) renders the same mesh under
the same matrix in float64.
"""

from __future__ import annotations

import contextlib
import importlib
from unittest import mock

import numpy as np
import torch

from ..harness import traffic as traffic_mod
from ..references import mesh_raster

LIBRARY = "tile_raster"          # the library whose kernels K1 and K3 are


class System:
    record = None                # a frame is its matrix: nothing recorded

    def __init__(self, config: dict, mix: dict, seed: int, device, sink):
        from libnativecpurenderer_tpu_torch import MeshVideoPipeline
        self.width, self.height = config["width"], config["height"]
        scene = importlib.import_module(
            f"bench_torch.scenes.{config['scene']}")
        verts, faces, colors = scene.build()
        # the configuration's float32 inputs, given to both sides
        verts = verts.astype(np.float32)
        self.textured = mix["surface"] == "textured"
        if self.textured:
            if not mix["render"].get("perspective_correct", True):
                raise ValueError("the reference interpolates uvs "
                                 "perspective-correct only")
            th, tw = mix["texture"]
            gen = torch.Generator(device=device)
            gen.manual_seed(int(traffic_mod.seed_rng(seed, 3).integers(1 << 62)))
            tex = torch.randint(0, 256, (th, tw, 4), generator=gen,
                                device=device, dtype=torch.uint8)
            uvs = scene.planar_uvs(verts.astype(np.float64)).astype(
                np.float32)
            surface = dict(uvs=uvs, tex_u8=tex.cpu().numpy())
            self.ref_mesh = dict(uvs=torch.from_numpy(uvs), tex=tex)
        else:
            colors = colors.astype(np.float32)
            surface = dict(colors=colors)
            self.ref_mesh = dict(colors=torch.from_numpy(colors))
        self.ref_mesh.update(verts=torch.from_numpy(verts),
                             faces=torch.from_numpy(faces))
        kw = {k: config[k] for k in ("tile_w", "tile_h", "capacity",
                                     "span_x", "span_y")}
        kw.update(mix["render"])
        self.pipe = MeshVideoPipeline(sink, self.width, self.height, verts,
                                      faces, batch=config["batch"],
                                      device=device, **surface, **kw)
        self.batch = config["batch"]

    def submit(self, mvp) -> None:
        self.pipe.submit(mvp)

    def finish(self) -> None:
        self.pipe.finish()

    def close(self) -> None:
        self.pipe = None

    def _ref_mesh(self, device):
        return {k: v.to(device) for k, v in self.ref_mesh.items()}

    def reference(self, mvp, device, control=False):
        """The reference's u8 frame of one frame's matrix (the control's
        with ``control``: float32 with a TF32 projection)."""
        kw = (dict(dtype=torch.float32, tf32=True) if control
              else dict(dtype=torch.float64))
        return mesh_raster.render(self._ref_mesh(device),
                                  torch.from_numpy(mvp), self.width,
                                  self.height, **kw)[0]

    def work(self, inputs, device) -> dict:
        """What the raster must do for these frames, counted from their
        inputs by the reference: covered fragments, pixels and the bytes
        of the mesh, keyed by the roofline's layer."""
        mesh = self._ref_mesh(device)
        fragments = pixels = 0
        for m in inputs:
            _, n_frag, n_px = mesh_raster.render(
                mesh, torch.from_numpy(m), self.width, self.height)
            fragments += n_frag
            pixels += n_px
        v = mesh["verts"].shape[0]
        f = mesh["faces"].shape[0]
        surface_bytes = (v * 2 * 4 + mesh["tex"].numel() if self.textured
                         else v * 4 * 4)
        return {"raster": {
            "frames": len(inputs), "fragments": fragments,
            "covered_pixels": pixels,
            "pixels": len(inputs) * self.width * self.height,
            "input_bytes": len(inputs) * (v * 3 * 4 + f * 3 * 4 + 16 * 4
                                          + surface_bytes),
            "textured": self.textured}}


def fault(kind: str):
    """``faults.KINDS``' ``kind`` planted in the raster's loop entries: a
    batch's later frames repeat its first (``unchanged``), its second
    half zero (``half``), or a 32x32 block of every frame flipped
    (``altered``)."""
    from libnativecpurenderer_tpu_torch.ops import raster3d
    stack = contextlib.ExitStack()
    for name in ("render_gouraud_u8_loop", "render_textured_u8_loop"):
        real = getattr(raster3d, name)

        def fake(*a, _real=real, **kw):
            frames, ovf = _real(*a, **kw)
            frames = frames.clone()
            if kind == "unchanged":
                frames[1:] = frames[:1]
            elif kind == "half":
                frames[frames.shape[0] // 2:] = 0
            else:
                frames[:, 8:40, 8:40] ^= 0x55
            return frames, ovf
        stack.enter_context(mock.patch.object(raster3d, name, fake))
    return stack


def small(cell, textured: bool = False):
    """The cell cut for the CPU tests: 160x96 at batch 2, the raster's
    runs long enough for the whole mesh at that size (capacity 4096, span
    8x8); with ``textured`` the textured surface, with the limit its cell
    read on the card (no cell of BENCHMARK.json runs it now).  Returns
    the configuration, mix and limits, and the seconds of a CPU window
    that holds two batches of the plain raster (a frame takes 0.2-0.4 s
    there)."""
    config = dict(cell.config, width=160, height=96, batch=2, capacity=4096,
                  span_x=8, span_y=8)
    mix, limits = cell.mix, cell.limits
    if textured:
        mix = dict(mix, surface="textured", texture=[16, 16],
                   render={"perspective_correct": True, "z_clip": True})
        limits = {"worst_frame_off_share": 4e-4}
    return config, mix, limits, 2.0
