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

import importlib

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
