"""Carrying state from host arrays (and from the JAX package) into the port.

The port's functions take tensors and run on their device.  These
helpers build those tensors: the mesh arrays that parameterise a render,
the per-frame prep arrays of the JAX package (so that a test can feed
JAX's own binning and row table into the port's tile kernel), and a
canvas's recorded commands, framebuffer and atlas (so that a test can
replay a JAX context's flush in the port), and an audio clip's samples
and rate snapshot.  All take numpy-convertible
arrays (a JAX array converts with ``np.asarray``); none imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config


def as_device(dev) -> torch.device:
    """``torch.device(dev)``, refusing a CUDA device on a machine without
    one: the port never falls back to the CPU behind the caller's back."""
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions")
    return dev


def mesh_to_torch(verts, faces, colors, device, dtype=None):
    """Mesh arrays -> (verts (V, 3) float, faces (F, 3) int64,
    colors (V, 4) float) on ``device``, floats in ``dtype`` (default
    ``config.default_dtype()``)."""
    dev = as_device(device)
    dtype = dtype or config.default_dtype()

    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return (f(verts),
            torch.tensor(np.asarray(faces), dtype=torch.int64, device=dev),
            f(colors))


def textured_mesh_to_torch(verts, faces, uvs, tex_u8, device, dtype=None):
    """Textured mesh arrays -> (verts (V, 3) float, faces (F, 3) int64,
    uvs (V, 2) float, tex_u8 (th, tw, 4) uint8) on ``device``, floats in
    ``dtype`` (default ``config.default_dtype()``)."""
    dev = as_device(device)
    dtype = dtype or config.default_dtype()
    tex = np.asarray(tex_u8)
    if tex.ndim != 3 or tex.shape[-1] != 4:
        raise ValueError(f"texture must be (th, tw, 4), got {tex.shape}")
    return (torch.tensor(np.asarray(verts), dtype=dtype, device=dev),
            torch.tensor(np.asarray(faces), dtype=torch.int64, device=dev),
            torch.tensor(np.asarray(uvs), dtype=dtype, device=dev),
            torch.tensor(tex, dtype=torch.uint8, device=dev))


def prep_to_torch(sorted_pad, starts, counts, table, device):
    """Per-frame prep of the flat binned raster (``bin_triangles_flat``'s
    sorted pair array, starts and counts, ``build_table``'s row table) ->
    int32 / float32 tensors on ``device``, the types the tile
    kernel takes."""
    return kernel_inputs_to_torch(device, np.asarray(sorted_pad, np.int32),
                                  np.asarray(starts, np.int32),
                                  np.asarray(counts, np.int32),
                                  np.asarray(table, np.float32))


def kernel_inputs_to_torch(device, *arrays):
    """Arrays the tile kernels take (a JAX prep's ``bins``, ``counts`` and
    row table for the gridded kernel, its dynrows ``rows``, ``starts``
    and ``counts``, or its sorted pairs, runs and ``build_table_mxu``
    table for the matrix-unit walk) -> tensors on ``device``: integer
    arrays as int32, float arrays as float32, shapes kept."""
    dev = as_device(device)
    out = []
    for a in arrays:
        a = np.asarray(a)
        dtype = (torch.int32 if np.issubdtype(a.dtype, np.integer)
                 else torch.float32)
        out.append(torch.tensor(a, dtype=dtype, device=dev))
    return tuple(out)


def commands_to_torch(kinds, params, dtype, device):
    """A recorded command list (a JAX context's ``_cmds.snapshot()``:
    kinds (N,) int32, params (N, 32) float64) -> (kinds as a host int32
    tensor, params cast to ``dtype`` on ``device``): what
    ``context.execute`` and the K4 wrapper take."""
    dev = as_device(device)
    return (torch.tensor(np.asarray(kinds), dtype=torch.int32),
            torch.tensor(np.asarray(params), dtype=torch.float64).to(
                dtype=dtype, device=dev))


def canvas_to_torch(fb, atlas, device):
    """A canvas state (a JAX context's ``_fb`` and its store's atlas) ->
    (fb, atlas) tensors on ``device``, each in its own float dtype."""
    dev = as_device(device)
    return (torch.tensor(np.asarray(fb), device=dev),
            torch.tensor(np.asarray(atlas), device=dev))


def audio_clip_to_torch(sample_rate, channels, pcm, device, cached_rate=None):
    """An audio clip's state (a JAX clip's ``np.asarray(clip._buf)``, its
    rate and channels, and its ``_cached_rate``, which ``cut`` in seconds
    reads) -> an ``AudioClip`` of the port on ``device``, its samples in
    their own float dtype."""
    from .audio import AudioClip
    clip = AudioClip._from_device(
        sample_rate, channels,
        torch.tensor(np.asarray(pcm), device=as_device(device)))
    if cached_rate is not None:
        clip._cached_rate = int(cached_rate)
    return clip
