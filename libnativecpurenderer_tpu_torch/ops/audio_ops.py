"""Device ops for the audio engine.

Counterpart of ``libnativecpurenderer_tpu/ops/audio_ops.py``: the
reference AudioClip math (``libNativeCPURenderer.cpp:998-1283``) as torch
ops that run on the device of their tensors.  No Pallas kernel lies on
this path (the JAX module is XLA gathers, scatters and FFTs), so these are
torch ops, arranged so that the card and the CPU give the same bits:

* **Fixed order of the overlay sums.**  Float ``index_add_`` on CUDA sums
  with atomics in no fixed order.  XLA:CPU's scatter adds the flattened
  updates in order, so a target row gets its contributions in event order.
  The scatter route here is one in-place slice add per event (or two, see
  below), which gives that order on every device.
* **JAX's ``mode="drop"``.**  ``x.at[idx].add(v, mode="drop")`` first
  wraps a negative row in ``[-N, 0)`` to the end of the target, then drops
  rows outside ``[0, N)``.  ``_drop_segments`` cuts an event into the
  (at most two) contiguous runs of rows that survive that.
* **No division on the device.**  CUDA divides by a Python scalar as a
  multiply by its reciprocal; XLA:CPU folds the JAX op's divisions by
  constants into such multiplies too.  ``resample`` takes the reciprocals
  on the host, in the buffer's dtype, as XLA folds them, and only
  multiplies on the device.

Donation has no counterpart: the ops that the JAX ``AudioClip`` rebinds
its buffer to (``overlay*``, ``gain``) update the target in place and
return it.  None of them takes part in autograd.

The FFT route of :func:`overlay_many` is the span ``lncr.audio.fft``
(``tracing``).  Counters, reset to 0 here: ``overlay_many.fft``, the
calls that take the FFT route; ``overlay_many.events``, the events that
survive the drop on either route of :func:`overlay_many` (its scatter
route included, and :func:`overlay_many_bucketed`, ``AudioClip``'s way
onto that route); ``overlay_groups.groups``, ``.events`` and
``.segments``, the groups :func:`overlay_groups` took, their events that
survive the drop and the slice adds (so the launches) they made.  Each
counter moves once a call, after the loop over the events.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from .. import tracing

# The padding start the JAX package gives the events of a power-of-two
# bucket that it does not use (its ``audio.py:391-393``): past any
# target, so dropped.
SENTINEL = 1 << 30
# overlay_many's route threshold on events x source rows (``:45``)
FFT_ABOVE = 1 << 20


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype on its device."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _as_starts(starts) -> np.ndarray:
    """Host start frames as int64 values after the JAX package's int32
    conversion (``jnp.asarray(starts, jnp.int32)``, which wraps)."""
    return np.asarray(starts).astype(np.int64).astype(np.int32).astype(
        np.int64).reshape(-1)


def _drop_segments(start: int, n: int, rows: int) -> List[Tuple[int, int,
                                                                int]]:
    """(src_lo, src_hi, dst_lo) runs of an event of ``n`` source rows at
    ``start`` that survive JAX's ``mode="drop"`` on a target of ``rows``
    rows, in source-row order: rows in ``[-rows, 0)`` wrap to the end of
    the target, rows outside ``[-rows, rows)`` are dropped."""
    out = []
    lo, hi = max(start, -rows), min(start + n, 0)
    if lo < hi:
        out.append((lo - start, hi - start, lo + rows))
    lo, hi = max(start, 0), min(start + n, rows)
    if lo < hi:
        out.append((lo - start, hi - start, lo))
    return out


def _scatter(target: torch.Tensor, source: torch.Tensor,
             starts: Iterable[int]) -> Tuple[int, int]:
    """The scatter route: ``source`` added into ``target`` at each start,
    in place, events in order (XLA:CPU's order of the flattened updates).
    Returns the number of events that survive the drop and the number of
    slice adds made (one a run of an event, so at most two an event)."""
    rows, n = target.shape[0], source.shape[0]
    kept = adds = 0
    for s in starts:
        segments = _drop_segments(int(s), n, rows)
        kept += bool(segments)
        adds += len(segments)
        for a, b, d in segments:
            target[d:d + b - a] += source[a:b]
    return kept, adds


def overlay(target: torch.Tensor, source: torch.Tensor,
            start: int) -> torch.Tensor:
    """Additive overlay of ``source`` (n, C) into ``target`` (N, C) at frame
    ``start``, in place; rows outside the target follow ``mode="drop"``
    (cpp:1129-1154)."""
    _scatter(target, source, _as_starts([start]))
    return target


def overlay_many(target: torch.Tensor, source: torch.Tensor,
                 starts) -> torch.Tensor:
    """Overlay of one source at many start frames, in place.

    The route follows the JAX op's (``:43-69``): the scatter route when
    ``len(starts) * n <= 2**20``, else an FFT convolution of the impulse
    train with the clip.  On the FFT route a start at or past the target's
    end moves to ``m`` (dropped), a start in ``[-m, 0)`` wraps within the
    length-``m`` impulse train, and duplicate starts sum; ``torch.fft``
    (cuFFT on the card, pocketfft on the CPU) gives other bits than JAX's
    FFT and than each other, within 1e-9 in float64 at bench scale."""
    st = _as_starts(starts)
    n = source.shape[0]
    if st.size * n <= FFT_ABOVE:
        overlay_many.events += _scatter(target, source, st)[0]
        return target
    with tracing.span("lncr.audio.fft"):
        overlay_many.fft += 1
        rows, c = target.shape
        m = 1
        while m < rows + n:
            m *= 2
        st = np.where(st >= rows, m, st)
        st = np.where(st < 0, st + m, st)
        st = st[(st >= 0) & (st < m)]
        overlay_many.events += st.size
        dev, dtype = target.device, target.dtype
        imp = torch.zeros((m,), dtype=dtype, device=dev)
        # sums of ones: exact in any order, so index_add_ is deterministic
        idx = torch.from_numpy(st).to(dev)
        imp.index_add_(0, idx, torch.ones(idx.shape, dtype=dtype, device=dev))
        src_pad = torch.zeros((m, c), dtype=dtype, device=dev)
        src_pad[:n] = source
        spec = torch.fft.rfft(src_pad, dim=0)
        ispec = torch.fft.rfft(imp)
        mixed = torch.fft.irfft(ispec[:, None] * spec, n=m, dim=0)[:rows]
        return target.add_(mixed.to(dtype))


overlay_many.fft = 0
overlay_many.events = 0


def overlay_many_bucketed(target: torch.Tensor, source: torch.Tensor,
                          src_len: int, starts) -> torch.Tensor:
    """The scatter route of :func:`overlay_many` over the first ``src_len``
    rows of ``source`` (the JAX op masks the rows of a power-of-two padded
    source; here nothing is compiled per length, so nothing is padded)."""
    overlay_many.events += _scatter(target, source[:int(src_len)],
                                    _as_starts(starts))[0]
    return target


def overlay_groups(target: torch.Tensor, sources: Sequence[torch.Tensor],
                   src_lens: Sequence[int], starts) -> torch.Tensor:
    """Groups ``k`` in order, each the first ``src_lens[k]`` rows of the
    (L_k, C) tensor ``sources[k]`` overlaid at the host start frames
    ``starts[k]`` on the scatter route, in place: the JAX op's loop
    (``:93-116``)."""
    kept = adds = 0
    for k in range(len(src_lens)):
        got = _scatter(target, sources[k][:int(src_lens[k])],
                       _as_starts(starts[k]))
        kept += got[0]
        adds += got[1]
    overlay_groups.groups += len(src_lens)
    overlay_groups.events += kept
    overlay_groups.segments += adds
    return target


overlay_groups.groups = 0
overlay_groups.events = 0
overlay_groups.segments = 0


def gain(buf: torch.Tensor, g: float) -> torch.Tensor:
    """ApplyVolumeGain (cpp:1254-1259), in place; ``g`` rounded to the
    buffer's dtype as ``jnp.asarray(g, dtype)`` does."""
    return buf.mul_(float(g))


def resample(buf: torch.Tensor, new_num: int, new_channels: int,
             new_rate: int, old_rate) -> torch.Tensor:
    """ApplyResampleAudioClip (cpp:1063-1120), including its quirks:

    * the clamp bound mixes frames and channels: indices clamp to
      ``[0, numFrames - channels - 1]`` (cpp:1082-1084);
    * the lerp fraction is taken against the *clamped* floor index
      (cpp:1086), so it can exceed 1 near the end;
    * when channel counts differ, every output channel gets the channel
      mean (cpp:1095-1110).

    The arithmetic is the one XLA:CPU compiles the JAX op to, so that the
    port gives JAX's bits: ``i / new_rate * old_rate`` becomes ``i *
    (old_rate * (1 / new_rate))`` (the division by a constant folded into
    a multiply by its rounded reciprocal, then reassociated); the channel
    sums run from zero, channel by channel, and scale by ``1 / channels``;
    and LLVM fuses the lerp's multiply and add (``fma(v_hi - v_lo, frac,
    v_lo)``) and, across channel counts, the scaled difference
    (``fma(sum_hi, 1 / channels, -s_lo)``).  ``torch.addcmul`` is that
    fused multiply-add on the CPU and on the card.  The scalar factors
    are rounded on the host, so the card multiplies by the same numbers
    as the CPU and divides by none.

    All of it runs in float64, as the reference's doubles do, whatever
    the buffer's dtype, and the result is cast back to that dtype.  In
    float32 the source index (~48,000 at a 1 s 48 kHz clip's end, a step
    of 2^-8) would be off by up to ~0.005 frames, which moves a high
    note's samples by up to 7 int16 levels.  So a float64 buffer gets
    JAX's bits, and a float32 one JAX's float64 bits rounded to float32."""
    out_dtype = buf.dtype
    buf = buf.to(torch.float64)
    num_frames, channels = buf.shape
    real = np.float64
    step = real(old_rate) * (real(1) / real(new_rate))
    old_idx = torch.arange(new_num, dtype=buf.dtype,
                           device=buf.device) * _scalar(step, buf)
    bound = num_frames - channels  # sic (cpp:1082)
    lo = torch.clamp(torch.floor(old_idx), 0, bound - 1)
    hi = torch.clamp(torch.ceil(old_idx), 0, bound - 1)
    frac = old_idx - lo
    lo, hi = lo.long(), hi.long()
    if channels == new_channels:
        v_lo = buf[lo]
        return torch.addcmul(v_lo, buf[hi] - v_lo,
                             frac[:, None]).to(out_dtype)

    def channel_sum(rows):
        s = torch.zeros(rows.shape[0], dtype=buf.dtype, device=buf.device)
        for c in range(channels):
            s = s + rows[:, c]
        return s

    inv = torch.full((new_num,), real(1) / real(channels), dtype=buf.dtype,
                     device=buf.device)
    s_lo = channel_sum(buf[lo]) * inv
    diff = torch.addcmul(-s_lo, channel_sum(buf[hi]), inv)
    v = torch.addcmul(s_lo, diff, frac)
    return v.to(out_dtype)[:, None].expand(new_num,
                                          new_channels).contiguous()


def cut(buf: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """ApplyCutAudioClip (cpp:1265-1279).  The reference leaves the tail
    uninitialised when ``end`` exceeds the clip; this zero-fills.  The
    window is ``lax.dynamic_slice``'s on the clip padded with ``length``
    zero rows: a negative start counts from the end of the padded clip,
    then the start clamps into ``[0, n]``."""
    n, c = buf.shape
    start = int(start)
    if start < 0:
        start += n + length
    start = min(max(start, 0), n)
    out = torch.zeros((length, c), dtype=buf.dtype, device=buf.device)
    k = min(length, n - start)
    out[:k] = buf[start:start + k]
    return out


def to_int16(buf_np) -> np.ndarray:
    """SaveAudioClipAsWav's sample conversion (cpp:1216-1222) on host
    arrays: clamp to [-1, 1], scale by 32767, truncate toward zero."""
    v = np.clip(np.asarray(buf_np, np.float64), -1.0, 1.0) * 32767.0
    return v.astype(np.int16)


def to_int16_device(buf: torch.Tensor) -> torch.Tensor:
    """The same conversion on the buffer's device, in its dtype (the
    conversion truncates toward zero for values in range, on both
    devices); halves the bytes a WAV export copies to the host."""
    return (torch.clamp(buf, -1.0, 1.0) * 32767.0).to(torch.int16)


def to_f32_device(buf: torch.Tensor) -> torch.Tensor:
    """float32 on the buffer's device before a host copy: the encoder
    paths want float32 PCM."""
    return buf.to(torch.float32)
