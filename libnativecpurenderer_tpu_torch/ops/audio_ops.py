"""Device ops for the audio engine.

Counterpart of ``libnativecpurenderer_tpu/ops/audio_ops.py``: the
reference AudioClip math (``libNativeCPURenderer.cpp:998-1283``) as torch
ops that run on the device of their tensors.  No Pallas kernel lies on
this path (the JAX module is XLA gathers, scatters and FFTs), so these are
torch ops, and one kernel of the port's own for the scatter route,
arranged so that the card and the CPU give the same bits:

* **Fixed order of the overlay sums.**  Float ``index_add_`` on CUDA sums
  with atomics in no fixed order.  XLA:CPU's scatter adds the flattened
  updates in order, so a target row gets its contributions in event order.
  Every scatter route here (``overlay``, ``overlay_many``'s scatter route,
  ``overlay_many_bucketed``, ``overlay_groups``) builds one ordered segment
  table on the host (:func:`segment_table`: a row a run of an event,
  groups, events and runs in order) and adds it into the target in table
  order (:func:`scatter_table`): on the card one launch of
  ``csrc/audio_scatter.cu``, whose blocks each hold a tile of the target
  and add the runs that meet it in table order; on the CPU one slice add a
  run (:func:`scatter_table_reference`).  Only adds, one rounded add at a
  time, in that order on every device.
* **JAX's ``mode="drop"``.**  ``x.at[idx].add(v, mode="drop")`` first
  wraps a negative row in ``[-N, 0)`` to the end of the target, then drops
  rows outside ``[0, N)``.  ``_drop_segments`` cuts an event into the
  (at most two) contiguous runs of rows that survive that;
  :func:`segment_table` applies the same rule to every event at once.
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
survive the drop and the runs of their segment table (the CPU's slice
adds); ``scatter_table.launches``, the kernel's launches (one a scatter
call on the card with a run to add, none on the CPU).  Each counter
moves once a call.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def segment_table(rows: int, src_lens: Sequence[int],
                  starts: Sequence) -> Tuple[np.ndarray, int]:
    """The scatter route's ordered segment table: groups ``k`` in order,
    each the first ``src_lens[k]`` source rows overlaid at the host start
    frames ``starts[k]`` onto a target of ``rows`` rows.  Each start takes
    :func:`_as_starts`' int32 wrap, then :func:`_drop_segments`' rule, in
    int64 over every group's starts at once (no loop over the events).
    Returns the int64 (runs, 4) table of rows (dst_lo, len, src_lo, k):
    groups in order, events in order within a group, an event's wrapped
    run before its in-range run, dead runs dropped; and the number of
    events with a run (those that survive the drop)."""
    if len(starts) != len(src_lens):
        raise ValueError(f"{len(src_lens)} source lengths for "
                         f"{len(starts)} groups of starts")
    # each group's starts cast to int64 on its own, as _as_starts does
    s = _as_starts(np.concatenate(starts, axis=None, dtype=np.int64,
                                  casting="unsafe")) if len(starts) else \
        np.zeros(0, np.int64)
    group = np.repeat(np.arange(len(starts), dtype=np.int64),
                      [np.size(g) for g in starts])
    end = s + np.asarray(src_lens, np.int64).reshape(-1)[group]
    # column 0 the wrapped run ([-rows, 0) -> the end), column 1 in range
    lo = np.maximum(s[:, None], np.array([-rows, 0], np.int64))
    hi = np.minimum(end[:, None], np.array([0, rows], np.int64))
    live = lo < hi
    kept = int(np.count_nonzero(live.any(1)))
    at = np.flatnonzero(live)
    ev = at >> 1
    lo, hi = lo.reshape(-1)[at], hi.reshape(-1)[at]
    table = np.empty((at.size, 4), np.int64)
    table[:, 0] = np.where(lo < 0, lo + rows, lo)
    table[:, 1] = hi - lo
    table[:, 2] = lo - s[ev]
    table[:, 3] = group[ev]
    return table, kept


def scatter_table_reference(target: torch.Tensor,
                            sources: Sequence[torch.Tensor],
                            table: np.ndarray) -> torch.Tensor:
    """Plain version of :func:`scatter_table`: one in-place slice add a
    run, in table order."""
    for d, n, a, k in table.tolist():
        target[d:d + n] += sources[k][a:a + n]
    return target


def _table_sources(target: torch.Tensor, sources: Sequence[torch.Tensor],
                   table: np.ndarray) -> Tuple[List[torch.Tensor], int, int]:
    """``sources`` as the executor reads them, after the checks: each
    contiguous (a copy where it is not) and a copy where it shares memory
    with the target (the JAX op reads a source as it was before the call);
    and the target rows ``[lo, hi)`` that the table's runs span (0, 0 for
    an empty table).  Raises unless the target is (N, C), each source
    (L_k, C) of its dtype on its device and every run of the table inside
    the target and its group's source."""
    if target.dim() != 2:
        raise ValueError(f"the target is {tuple(target.shape)}, not (N, C)")
    rows, c = target.shape
    dev, dtype = target.device, target.dtype
    t_lo = target.data_ptr()
    t_hi = t_lo + target.nbytes
    out, lens = [], []
    for k, src in enumerate(sources):
        if src.device != dev or src.dim() != 2 or src.shape[1] != c \
                or src.dtype != dtype:
            raise ValueError(f"source {k} is {tuple(src.shape)} "
                             f"{src.dtype} on {src.device}, not (L, {c}) "
                             f"{dtype} on {dev}")
        if not src.is_contiguous():
            src = src.contiguous()
        p = src.data_ptr()
        if p < t_hi and t_lo < p + src.nbytes:
            src = src.clone()
        out.append(src)
        lens.append(src.shape[0])
    if table.dtype != np.int64 or table.ndim != 2 or table.shape[1] != 4:
        raise ValueError(f"the table is {table.shape} {table.dtype}, not "
                         f"int64 (runs, 4)")
    if not table.size:
        return out, 0, 0
    d, n, a, k = table.T
    least = table.min(0)              # of dst_lo, len, src_lo, group
    hi = int((d + n).max())
    if least[0] < 0 or least[1] <= 0 or least[2] < 0 or least[3] < 0 \
            or hi > rows or k.max() >= len(out) \
            or (a + n > np.asarray(lens, np.int64)[k]).any():
        raise ValueError("a run of the table lies outside the target or "
                         "its source")
    return out, int(least[0]), hi


def scatter_table(target: torch.Tensor, sources: Sequence[torch.Tensor],
                  table: np.ndarray) -> torch.Tensor:
    """Each run (dst_lo, len, src_lo, k) of ``table`` (from
    :func:`segment_table`) added in table order, in place: target rows
    ``[dst_lo, dst_lo + len)`` += rows ``[src_lo, src_lo + len)`` of
    ``sources[k]``; returns ``target``.  target: (N, C), contiguous and
    float32 or float64 on the card; sources: (L_k, C) tensors of its
    dtype on its device (made contiguous or copied where needed: see
    :func:`_table_sources`), held by the caller until the device is done
    with them.

    CUDA tensors launch ``csrc/audio_scatter.cu`` once on the current
    stream, over the tiles of the target rows the runs span, after one
    non-blocking upload of the table and the sources' pointers, in one
    buffer from pinned memory (no sync; nothing for an empty table).  CPU
    tensors run :func:`scatter_table_reference`.  Either way every target
    element receives its contributions in table order, one rounded add at
    a time, so the two give the same bits."""
    sources, row_lo, row_hi = _table_sources(target, sources, table)
    dev = target.device
    if dev.type == "cpu":
        return scatter_table_reference(target, sources, table)
    if dev.type != "cuda":
        raise ValueError(f"no scatter kernel for device {dev}")
    if target.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"no scatter kernel for {target.dtype}")
    if not target.is_contiguous():
        raise ValueError("the target must be contiguous")
    rows, c = target.shape
    if not table.size or not rows * c:
        return target
    from . import _kernels
    host = np.concatenate([table.reshape(-1), np.array(
        [s.data_ptr() for s in sources], np.int64)])
    up = torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _kernels.launch_audio_scatter(
            target.data_ptr(), rows, c, row_lo, row_hi, up.data_ptr(),
            len(table), up.data_ptr() + 8 * table.size,
            target.dtype == torch.float64, stream)
    scatter_table.launches += 1
    return target


scatter_table.launches = 0


def _scatter(target: torch.Tensor, sources: Sequence[torch.Tensor],
             src_lens: Sequence[int], starts: Sequence) -> Tuple[int, int]:
    """The scatter route: groups ``k`` in order, the first
    ``src_lens[k]`` rows of ``sources[k]`` added into ``target`` at each
    of the host start frames ``starts[k]``, in place, through one segment
    table (XLA:CPU's order of the flattened updates).  Returns the events
    that survive the drop and the table's runs."""
    lens = [slice(int(m)).indices(s.shape[0])[1]
            for s, m in zip(sources, src_lens, strict=True)]
    table, kept = segment_table(target.shape[0], lens, starts)
    scatter_table(target, sources, table)
    return kept, len(table)


def overlay(target: torch.Tensor, source: torch.Tensor,
            start: int) -> torch.Tensor:
    """Additive overlay of ``source`` (n, C) into ``target`` (N, C) at frame
    ``start``, in place; rows outside the target follow ``mode="drop"``
    (cpp:1129-1154)."""
    _scatter(target, [source], [source.shape[0]], [[start]])
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
        overlay_many.events += _scatter(target, [source], [n], [st])[0]
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
    overlay_many.events += _scatter(target, [source], [src_len],
                                    [starts])[0]
    return target


def overlay_groups(target: torch.Tensor, sources: Sequence[torch.Tensor],
                   src_lens: Sequence[int], starts) -> torch.Tensor:
    """Groups ``k`` in order, each the first ``src_lens[k]`` rows of the
    (L_k, C) tensor ``sources[k]`` overlaid at the host start frames
    ``starts[k]`` on the scatter route, in place: the JAX op's loop
    (``:93-116``)."""
    kept, runs = _scatter(target, sources, src_lens, starts)
    overlay_groups.groups += len(src_lens)
    overlay_groups.events += kept
    overlay_groups.segments += runs
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
