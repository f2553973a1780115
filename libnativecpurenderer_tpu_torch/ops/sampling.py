"""Texture sampling and resampling, in PyTorch.

Counterpart of ``libnativecpurenderer_tpu/ops/sampling.py``.  Mirrors
``InterpolateColorFromBuffer`` (``libNativeCPURenderer.cpp:555-573``,
nearest-neighbour: the bilinear path is commented out in the reference)
and ``ResampleTexture`` (cpp:950-976).  ``atlas`` is an ``(AH, AW, 4)``
float tensor; the functions run on its device.
"""

from __future__ import annotations

import torch


def _to_i32(x):
    """float -> int32 as XLA converts (``.astype(jnp.int32)``): truncate
    toward zero, saturate out of range, NaN -> 0.  ``Tensor.to(int32)``
    leaves those cases undefined (the CPU gives INT_MIN).  2**31 - 128 is
    the largest float32 below 2**31, 2**31 - 1 the largest float64 that
    truncates into range.  The texel lookups of the canvas and the mesh
    walks share it."""
    hi = 2.0 ** 31 - (1 if x.dtype == torch.float64 else 128)
    y = torch.nan_to_num(x, nan=0.0).clamp(-2.0 ** 31, hi)
    return torch.where(x >= 2.0 ** 31, torch.iinfo(torch.int32).max,
                       y.to(torch.int32))


def clamp_coord(x, size):
    """Reference clamp quirk (cpp:560-563): x<0 -> 0, x>=size-1 -> size-2."""
    x = torch.where(x < 0.0, 0.0, x)
    return torch.where(x >= size - 1.0, size - 2.0, x)


def _grid(out_w: int, out_h: int, dtype, device):
    i = torch.arange(out_w, dtype=dtype, device=device).expand(out_h, out_w)
    j = torch.arange(out_h, dtype=dtype, device=device)[:, None].expand(
        out_h, out_w)
    return i, j


def _scalar(v, like):
    """``v`` as a 0-d tensor of ``like``'s dtype and device: torch divides
    by a Python scalar on CUDA as a multiply by its reciprocal, which is
    not the quotient's rounding."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def resample_region(atlas, ox: int, oy: int, tw, th, out_w: int,
                    out_h: int):
    """ResampleTexture semantics (cpp:950-976): for each output texel (i, j)
    sample the source at ((i/out_w)*tw, (j/out_h)*th), nearest with the
    reference clamp."""
    i, j = _grid(out_w, out_h, atlas.dtype, atlas.device)
    x = clamp_coord(i / _scalar(out_w, i) * tw, tw)
    y = clamp_coord(j / _scalar(out_h, j) * th, th)
    xi = _to_i32(x) + ox
    yi = _to_i32(y) + oy
    return atlas[yi.long(), xi.long()]


def resample_region_bilinear(atlas, ox: int, oy: int, tw, th, out_w: int,
                             out_h: int):
    """Bilinear variant of resample_region — the quality upgrade the
    reference left commented out (cpp:575-620).  Opt-in (reference parity
    default stays nearest); sample positions use texel centres."""
    i, j = _grid(out_w, out_h, atlas.dtype, atlas.device)
    x = torch.clamp((i + 0.5) / _scalar(out_w, i) * tw - 0.5, 0.0, tw - 1.0)
    y = torch.clamp((j + 0.5) / _scalar(out_h, j) * th - 0.5, 0.0, th - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = _to_i32(x0)
    y0i = _to_i32(y0)
    x1i = torch.clamp(x0i + 1, max=int(tw) - 1)
    y1i = torch.clamp(y0i + 1, max=int(th) - 1)

    def tap(yy, xx):
        return atlas[(yy + oy).long(), (xx + ox).long()]

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx
    bot = tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def read_region(atlas, ox: int, oy: int, w: int, h: int):
    """A copy of the (h, w, 4) region of the atlas at (ox, oy)."""
    return atlas[oy:oy + h, ox:ox + w].clone()
