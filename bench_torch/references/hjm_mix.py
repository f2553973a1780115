"""The plain reference of the MIDI mixer: upstream's ``src/hjm_mixer.py``
(:22-97) over its AudioClip engine (``libNativeCPURenderer.cpp``: the
resample :1063-1120, the overlay :1129-1154, the WAV samples
:1216-1222), in plain torch, with nothing of the port.  It takes the
generator's own notes (``generators/midi_songs``: exact onsets in
seconds and note numbers), not a parse of the song's bytes.

* **The round-robin**: the instrument of a note is the index of its
  onset among the song's distinct onsets, mod 3 (``ha``, ``ji``, ``mi``),
  counted before the filter.
* **The filter**: the note shifted by ``dnote``, then kept within
  [``min_note``, ``max_note``].
* **The file quirk**: shifted note ``m`` plays file ``m + 12``.
* **The resample** of each bank file to the target's rate: the file's
  int16 samples / 32768; ``int(frames / old_rate * new_rate)`` rows; row
  i reads source index ``i / new_rate * old_rate``, whose floor and ceil
  clamp to [0, frames - channels - 1] (the bound mixes frames and
  channels), and the fraction is taken against the clamped floor.
* **The target**: silent, ``int((last onset + 1 s) x rate)`` rows.
* **The overlay**: each note's clip added at ``floor((onset + offset)
  x rate)``, rows past the end cut, in any order.
* **The WAV samples**: clamp to [-1, 1], x 32767, truncated to int16.

The arithmetic runs in ``dtype``: float64, as upstream's, or bfloat16
for the control.  Onsets are never negative here."""

from __future__ import annotations

from fractions import Fraction
from math import floor

import numpy as np
import torch

BANKS = 3
FILE_SHIFT = 12


def events(onsets_s, notes, min_note: int, max_note: int, dnote: int,
           offset_ms: int, rate: int) -> tuple:
    """(instrument, file, start frame) of each note that plays, in the
    song's order, and the target's rows."""
    index = {o: i for i, o in enumerate(sorted(set(onsets_s)))}
    shift = Fraction(offset_ms, 1000)
    out = []
    for o, n in zip(onsets_s, notes):
        m = int(n) + dnote
        if min_note <= m <= max_note:
            out.append((index[o] % BANKS, m + FILE_SHIFT,
                        floor((o + shift) * rate)))
    return out, floor((max(onsets_s) + 1) * rate)


def resample(pcm: np.ndarray, old_rate: int, new_rate: int, dtype,
             device) -> torch.Tensor:
    """The int16 (frames, C) file ``pcm`` as a (rows, C) clip at
    ``new_rate``, computed in ``dtype``."""
    frames, channels = pcm.shape
    x = torch.from_numpy(np.ascontiguousarray(pcm)).to(device).to(
        dtype) / 32768.0
    rows = int(frames / old_rate * new_rate)
    idx = torch.arange(rows, device=device).to(dtype) / new_rate * old_rate
    bound = frames - channels
    # the clamp on whole numbers: a bfloat16 bound would round past it
    lo = torch.floor(idx).long().clamp(0, bound - 1)
    hi = torch.ceil(idx).long().clamp(0, bound - 1)
    frac = idx - lo.to(dtype)
    v_lo = x[lo]
    return v_lo + (x[hi] - v_lo) * frac[:, None]


def mix(evs, rows: int, channels: int, clip_of, dtype,
        device) -> torch.Tensor:
    """The int16 (rows, C) samples of the events ``evs`` (``events``)
    overlaid onto a silent target; ``clip_of(instrument, file)`` gives a
    resampled clip in ``dtype``."""
    out = torch.zeros((rows, channels), dtype=dtype, device=device)
    for inst, f, s in evs:
        if s < 0:
            raise ValueError("the reference takes no negative onset")
        src = clip_of(inst, f)
        k = min(src.shape[0], rows - s)
        if k > 0:
            out[s:s + k] += src[:k]
    return (out.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
