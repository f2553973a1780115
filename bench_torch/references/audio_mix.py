"""The plain reference of the demo mixdown: upstream's overlay and WAV
sample conversion (``libNativeCPURenderer.cpp:1129-1154`` and
``:1216-1222``), in plain torch, with no FFT and nothing of the port.

Each event starts at the int64 truncation of its offset in seconds times
the rate, and adds the sound's rows that fall inside the clip, in event
order: rows past the clip's end are cut, so an event that starts at or
past it adds nothing.  Then every sample is clamped to [-1, 1], scaled by
32767 and truncated toward zero to int16.  The arithmetic runs in
``dtype``: float64, as upstream's, or bfloat16 for the control.  Offsets
are never negative here (upstream skips rows before the clip; the port
follows the JAX package's wrap there, which no deployment reaches)."""

from __future__ import annotations

import numpy as np
import torch


def start_frames(offsets_s, rate: int) -> np.ndarray:
    """Each offset's first frame: seconds x rate, truncated to int64."""
    return (np.asarray(offsets_s, np.float64) * rate).astype(np.int64)


def mix(base: torch.Tensor, sound: torch.Tensor, offsets_s, rate: int,
        dtype=torch.float64) -> torch.Tensor:
    """The int16 (N, C) samples of ``sound`` (n, C) overlaid at each
    offset onto a copy of ``base`` (N, C), computed in ``dtype``."""
    out = base.to(dtype, copy=True)
    src = sound.to(dtype)
    rows, n = out.shape[0], src.shape[0]
    for s in start_frames(offsets_s, rate).tolist():
        if s < 0:
            raise ValueError("the reference takes no negative offset")
        k = min(n, rows - s)
        if k > 0:
            out[s:s + k] += src[:k]
    return (out.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
