"""libnativecpurenderer_tpu_torch — the PyTorch/CUDA port of
``libnativecpurenderer_tpu``, for one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against.  Slices so far:
  * mesh -> u8 frame: projection, edge setup and tile binning as torch
    ops, the per-tile visibility + Gouraud shading as a hand-written CUDA
    kernel (``csrc/tile_raster.cu``), and the Gouraud half of
    ``MeshVideoPipeline``;
  * textured mesh -> u8 frame: the same walk in the same CUDA source with
    texel epilogues (u8 texels, texel indices, float attributes and
    depth keys), and the textured half of ``MeshVideoPipeline``
    (``render_textured_u8_batch`` with ``mxu=0`` is
    ``render_textured_u8_loop`` under the JAX batch entry's defaults;
    with ``mxu=1|2`` it is one launch of K3's matrix-unit walk over the
    B frames);
  * the 2D canvas: ``RenderContext`` records draw calls on the host and
    its flush runs arithmetic commands and texture blits through a
    hand-written CUDA kernel (``csrc/canvas_span.cu``) and hit effects
    as torch ops;
  * the 2D frame pipeline: ``MultiThreadedVideoRenderContextPreparer``
    records frames without executing them, ``BatchedVideoPipeline``
    renders them in batches through the canvas flush from a shared
    ``fb0``, quantises them to u8 on the device and hands them to a sink;
    a shared texture the proxy samples is refreshed into fresh atlas
    regions, and the superseded ones are recycled once no pending frame
    can read them;
  * the float and depth Gouraud rasterizer: ``render_gouraud_pallas``
    and ``render_gouraud_pallas_batch`` (the gridded kernel over
    materialised bins, the flat f32 and u8 kernels, the kernel over rows
    gathered in pair order), ``near_clip`` on the binned entries, and the
    tensor-op paths ``render_gouraud`` (naive), ``render_gouraud_binned``
    and ``render_textured_binned``;
  * the blended quad batch (BASELINE config 2): ``render_blended_u8_loop``
    orders each frame's quads back to front, bins them by draw step and
    blends each tile's run in order in a hand-written CUDA kernel (K7,
    ``csrc/tile_blend.cu``), z-tested against an opaque depth, and the
    blended mode of ``MeshVideoPipeline`` (``blend=True``); its plain
    per-triangle version is ``render_blended``;
  * the ``wf=`` and ``mxu=`` routes of the u8 entries: ``wf=n`` of
    ``render_gouraud_u8`` and ``render_gouraud_pallas(flat=True,
    u8=True)`` walks with K1-wf, K1's split walk claiming n items at a
    time; ``mxu=1|2`` of
    those two, of ``render_gouraud_pallas_batch``'s u8 route and of
    ``render_textured_u8_batch`` walks an affine table on the tensor
    cores (K1-mxu, K3's matrix-unit walk);
  * the audio engine and the MIDI -> WAV path: ``AudioClip`` (and
    ``Int16CreatedAudioClip``, ``PtrCreatedAudioClip``) over the torch
    ops of ``ops/audio_ops`` (no kernel lies on this path: the overlay
    sums run in one fixed order, so the card and the CPU give the same
    bits, the FFT route aside), the host media loader ``media`` (the
    shared native runtime when built, stdlib WAV otherwise), the SMF
    parser ``models/midi`` and the apps ``apps/hjm_mixer`` and
    ``apps/hjm_mixer_server``.
Nothing here imports JAX.
"""

from . import config
from .audio import AudioClip, Int16CreatedAudioClip, PtrCreatedAudioClip
from .context import MultiThreadedVideoRenderContextPreparer, RenderContext
from .helpers import Helpers
from .interop import (audio_clip_to_torch, canvas_to_torch, commands_to_torch,
                      kernel_inputs_to_torch, mesh_to_torch, prep_to_torch,
                      textured_mesh_to_torch)
from .ops.raster3d import (pack_texture_u8, render_blended,
                           render_blended_u8_loop, render_gouraud,
                           render_gouraud_binned, render_gouraud_pallas,
                           render_gouraud_pallas_batch, render_gouraud_u8,
                           render_gouraud_u8_loop, render_textured,
                           render_textured_binned, render_textured_u8,
                           render_textured_u8_batch, render_textured_u8_loop)
from .pipeline import BatchedVideoPipeline, MeshVideoPipeline
from .texture import HitEffectTexture, PtrCreatedTexture, Texture

VERSION = 1  # same LIB_NATIVE_CPU_RENDERER_VERSION as the JAX package


def get_version() -> int:
    return VERSION


__all__ = [
    "AudioClip",
    "BatchedVideoPipeline",
    "Helpers",
    "HitEffectTexture",
    "Int16CreatedAudioClip",
    "MeshVideoPipeline",
    "MultiThreadedVideoRenderContextPreparer",
    "PtrCreatedAudioClip",
    "PtrCreatedTexture",
    "RenderContext",
    "Texture",
    "audio_clip_to_torch",
    "canvas_to_torch",
    "commands_to_torch",
    "config",
    "get_version",
    "kernel_inputs_to_torch",
    "mesh_to_torch",
    "pack_texture_u8",
    "prep_to_torch",
    "render_blended",
    "render_blended_u8_loop",
    "render_gouraud",
    "render_gouraud_binned",
    "render_gouraud_pallas",
    "render_gouraud_pallas_batch",
    "render_gouraud_u8",
    "render_gouraud_u8_loop",
    "render_textured",
    "render_textured_binned",
    "render_textured_u8",
    "render_textured_u8_batch",
    "render_textured_u8_loop",
    "textured_mesh_to_torch",
]
