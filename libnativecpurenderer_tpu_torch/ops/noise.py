"""Milthm hit-effect procedural noise, in PyTorch.

Counterpart of ``libnativecpurenderer_tpu/ops/noise.py``, same operation
order.  Ports the math of the reference's ``ShaderUtils`` namespace
(``libNativeCPURenderer.cpp:1318-1411``): GLSL-style sin-hash value noise,
3-octave circular polar noise, thresholded dissolve.  The functions take
tensors of any shape (and 0-d tensors or floats for ``seed`` and ``t``),
so the executor evaluates the effect per screen pixel.
"""

from __future__ import annotations

import torch


def _fract(x):
    return x - torch.floor(x)


def _rand(px, py):
    # rand(n) = fract(sin(dot(n, (12.9898, 78.233))) * 43758.5453)   cpp:1339-1341
    return _fract(torch.sin(px * 12.9898 + py * 78.233) * 43758.5453)


def value_noise(px, py):
    """cpp:1372-1383."""
    ix = torch.floor(px)
    iy = torch.floor(py)
    ux = px - ix
    uy = py - iy

    a = _rand(ix, iy)
    b = _rand(ix + 1.0, iy)
    c = _rand(ix, iy + 1.0)
    d = _rand(ix + 1.0, iy + 1.0)

    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)

    mix_ab = a + (b - a) * sx
    mix_cd = c + (d - c) * sx
    return mix_ab + (mix_cd - mix_ab) * sy


def circular_noise(uvx, uvy, density, seed):
    """cpp:1385-1403.  ``uvx/uvy`` in [0,1]; returns 3-octave polar noise."""
    cx = uvx - 0.5
    cy = uvy - 0.5
    radius = torch.sqrt(cx * cx + cy * cy) * density
    angle = torch.abs(torch.atan2(cy, cx))
    # if (uv.y > 0.5) angle += sin(angle) * 2.0;   cpp:1390-1392
    angle = torch.where(uvy > 0.5, angle + torch.sin(angle) * 2.0, angle)

    px = radius + seed * 100.0
    py = angle + seed * 100.0

    n = value_noise(px, py) * 0.7
    n = n + value_noise(px * 2.0, py * 2.0) * 0.3
    n = n + value_noise(px * 4.0, py * 4.0) * 0.1
    return n


def hit_effect_alpha(uvx, uvy, seed, t):
    """cpp:1406-1411: thresholded dissolve, alpha 0 where noise < t else 1."""
    n = circular_noise(uvx, uvy, 50.0, seed)
    return torch.where(n < t, 0.0, 1.0).to(n.dtype)
