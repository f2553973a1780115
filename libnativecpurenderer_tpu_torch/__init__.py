"""libnativecpurenderer_tpu_torch — the PyTorch/CUDA port of
``libnativecpurenderer_tpu``, for one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against.  This slice is the mesh -> u8 frame path:
projection, edge setup and tile binning as torch ops, the per-tile
visibility + Gouraud shading as a hand-written CUDA kernel
(``csrc/tile_raster.cu``), and the Gouraud half of ``MeshVideoPipeline``.
Nothing here imports JAX.
"""

from . import config
from .interop import mesh_to_torch, prep_to_torch
from .ops.raster3d import render_gouraud_u8, render_gouraud_u8_loop
from .pipeline import MeshVideoPipeline

VERSION = 1  # same LIB_NATIVE_CPU_RENDERER_VERSION as the JAX package


def get_version() -> int:
    return VERSION


__all__ = [
    "MeshVideoPipeline",
    "config",
    "get_version",
    "mesh_to_torch",
    "prep_to_torch",
    "render_gouraud_u8",
    "render_gouraud_u8_loop",
]
