"""AudioClip: float PCM clips with gain/resample/overlay/cut/speed + WAV.

Counterpart of ``libnativecpurenderer_tpu/audio.py``, with API parity to
the reference binding (``libNativeCPURendererPybind.py:503-659``) and
native engine (``libNativeCPURenderer.cpp:998-1283``).  The samples live
on a device as a (num_frames, channels) tensor in the default dtype
(``config.default_dtype()``), and every op runs there (``ops/audio_ops``).
Every constructor takes ``device=`` (the card by default, as
``RenderContext``); a clip made from another keeps its device.

Decoding goes through the shared native media runtime when it is built,
with a stdlib WAV fallback (``media.py``).

Spans (``tracing``): ``lncr.audio.overlay_many`` around
:meth:`AudioClip.overlay_many` (the FFT route inside it is
``lncr.audio.fft``, ``ops/audio_ops``); ``lncr.audio.overlay_groups``
around :meth:`AudioClip.overlay_groups` (the cohort sort and the scatter
route's slice adds); ``lncr.audio.save_as_wav`` around
:meth:`AudioClip.save_as_wav`, and inside it ``lncr.audio.copy_out`` (the
int16 quantise and, from the card, the pinned buffer and its copy
enqueued) and ``lncr.audio.assemble`` (the wait on the copy and the
RIFF bytes).  Counter, reset to 0 here: ``AudioClip.save_as_wav.bytes``,
the PCM bytes written.
"""

from __future__ import annotations

import struct
import typing

import numpy as np
import torch

from . import config, tracing
from .interop import as_device
from .ops import audio_ops


def _bucket(n: int) -> int:
    """The power of two at or above n (1 for n <= 1)."""
    b = 1
    while b < n:
        b *= 2
    return b


class AudioClip:
    def __init__(self, sample_rate: int, channels: int,
                 data: typing.Iterable[float], *, device="cuda"):
        # data is interleaved samples; num_frames = len(data) / channels
        # (the reference binding's channels-times over-count, pybind:510,
        # is not replicated)
        arr = np.asarray(list(data) if not isinstance(data, np.ndarray)
                         else data, dtype=np.float64)
        num_frames = arr.size // channels
        self._init_from_array(sample_rate, channels,
                              arr.reshape(num_frames, channels), device)

    def _init_from_array(self, sample_rate: int, channels: int,
                         arr: np.ndarray, device) -> None:
        self._init_from_device(
            sample_rate, channels,
            torch.tensor(arr, dtype=config.default_dtype(),
                         device=as_device(device)))

    def _init_from_device(self, sample_rate: int, channels: int,
                          buf: torch.Tensor) -> None:
        self._sample_rate = int(sample_rate)
        self._channels = int(channels)
        self._num_frames = int(buf.shape[0])
        # the binding's rate snapshot, refreshed only when a clip is made
        # or wrapped (pybind:512-526); cut()'s second -> frame conversion
        # reads it, stale after resample/apply_speed (parity, see cut())
        self._cached_rate = int(sample_rate)
        self._buf = buf

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def _from_array(cls, sample_rate, channels, arr, *,
                    device="cuda") -> "AudioClip":
        clip = cls.__new__(cls)
        clip._init_from_array(sample_rate, channels, np.asarray(arr), device)
        return clip

    @classmethod
    def _from_device(cls, sample_rate, channels, buf) -> "AudioClip":
        clip = cls.__new__(cls)
        clip._init_from_device(sample_rate, channels, buf)
        return clip

    @staticmethod
    def slient(sample_rate: int, channels: int, num_frames: int, *,
               device="cuda") -> "AudioClip":
        """CreateSilentAudioClip (cpp:1036-1046).  The typo'd name is the
        reference API (pybind:544); ``silent`` is an alias."""
        return AudioClip._from_device(
            sample_rate, channels,
            torch.zeros((int(num_frames), int(channels)),
                        dtype=config.default_dtype(),
                        device=as_device(device)))

    silent = slient

    @staticmethod
    def from_pydub_seg(seg, *, device="cuda") -> "AudioClip":
        """CreateAudioClipFromPydubSeg (pybind:530-541).  When pydub is
        installed the type is enforced; without it any object with the
        AudioSegment surface (sample_width / frame_rate / channels /
        get_array_of_samples / set_sample_width) is accepted."""
        try:
            from pydub import AudioSegment  # optional dependency
        except ImportError:
            AudioSegment = None
        if AudioSegment is not None and not isinstance(seg, AudioSegment):
            raise TypeError("seg must be a pydub.AudioSegment")
        if seg.sample_width != 2:
            seg = seg.set_sample_width(2)
        data = seg.get_array_of_samples(array_type_override="h")
        return Int16CreatedAudioClip(seg.frame_rate, seg.channels, data,
                                     device=device)

    @staticmethod
    def from_file(path: str, *, device="cuda") -> "AudioClip":
        """Decode an audio file (wav/ogg/mp3/...) to a clip: the native
        media runtime (libav) when it is built, else the stdlib WAV
        reader (``media.decode_audio``)."""
        from . import media
        rate, channels, pcm = media.decode_audio(path)
        return AudioClip._from_array(rate, channels, pcm, device=device)

    # ------------------------------------------------------------------ #
    # properties (cpp:1230-1244)
    # ------------------------------------------------------------------ #
    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def channels(self) -> int:
        return self._channels

    @property
    def num_frames(self) -> int:
        return self._num_frames

    @property
    def duration(self) -> float:
        return self._num_frames / self._sample_rate

    @property
    def device(self) -> torch.device:
        return self._buf.device

    def numpy(self) -> np.ndarray:
        """A host copy of the samples (the ops update the buffer in
        place, so a view would change under the caller)."""
        return self._buf.to("cpu", copy=True).numpy()

    # ------------------------------------------------------------------ #
    # ops
    # ------------------------------------------------------------------ #
    def clone(self) -> "AudioClip":
        """CloneAudioClip (cpp:1054-1061), on this clip's device."""
        return AudioClip._from_device(self._sample_rate, self._channels,
                                      self._buf.clone())

    def apply_volume_gain(self, g: float) -> None:
        """ApplyVolumeGain (cpp:1254-1259)."""
        audio_ops.gain(self._buf, g)

    def resample(self, sample_rate: int, channels: int) -> None:
        """ApplyResampleAudioClip (cpp:1063-1120); in place like the ref,
        and a no-op when the format already matches."""
        if self._sample_rate == sample_rate and self._channels == channels:
            return
        dur = self._num_frames / self._sample_rate
        new_num = int(dur * sample_rate)
        self._buf = audio_ops.resample(self._buf, new_num, int(channels),
                                       int(sample_rate), self._sample_rate)
        self._sample_rate = int(sample_rate)
        self._channels = int(channels)
        self._num_frames = new_num

    def resample_like(self, like: "AudioClip") -> None:
        self.resample(like._sample_rate, like._channels)

    def _matched(self, source: "AudioClip") -> "AudioClip":
        """``source``, or a copy of it resampled to this clip's format."""
        if self._sample_rate != source._sample_rate \
                or self._channels != source._channels:
            source = source.clone()
            source.resample_like(self)
        return source

    def overlay(self, source: "AudioClip", start_time,
                *, time_unit: str = "frame",
                auto_resample: bool = False) -> None:
        """OverlayAudioClip[Second] (cpp:1129-1163): additive, truncated at
        the target end; mismatched formats raise unless auto_resample."""
        if time_unit not in ("frame", "second"):
            raise ValueError("time_unit must be 'frame' or 'second'")
        if time_unit == "second":
            start_frame = int(start_time * self._sample_rate)
        else:
            start_frame = int(start_time)
        if auto_resample:
            source = self._matched(source)
        if self._sample_rate != source._sample_rate:
            raise ValueError(
                "target and source must have the same sample rate")
        if self._channels != source._channels:
            raise ValueError("target and source must have the channels")
        audio_ops.overlay(self._buf, source._buf, start_frame)

    def _starts(self, secs) -> np.ndarray:
        return (np.asarray(secs, np.float64)
                * self._sample_rate).astype(np.int64)

    def overlay_many(self, source: "AudioClip", start_seconds) -> None:
        """N overlays of one source (the same semantics as N ``overlay``
        calls), on the JAX package's route: the event count padded to a
        power-of-two bucket with dropped starts, then the scatter route
        when bucket x source rows <= 2**20, else the FFT route
        (the JAX package's ``audio.py:377-418``)."""
        with tracing.span("lncr.audio.overlay_many"):
            starts = self._starts(start_seconds)
            bucket = _bucket(len(starts))
            starts = np.concatenate(
                [starts, np.full(bucket - len(starts), audio_ops.SENTINEL,
                                 np.int64)])
            source = self._matched(source)
            n_src = int(source._buf.shape[0])
            if bucket * n_src <= audio_ops.FFT_ABOVE:
                audio_ops.overlay_many_bucketed(self._buf, source._buf,
                                                n_src, starts)
            else:
                audio_ops.overlay_many(self._buf, source._buf, starts)

    def overlay_groups(self, pairs) -> None:
        """Overlay many (source clip, start_seconds list) groups on the
        scatter route, in the JAX package's order (its
        ``audio.py:420-465``): cohorts sorted by (power-of-two event bucket, power-of-two source
        length bucket), groups in the order given within a cohort.  The
        cross-group float sums depend on that order, so it is kept,
        though the port compiles nothing per cohort and pads nothing:
        every group's events go into one ordered segment table, added
        into the clip in that order by one launch on the card
        (``audio_ops.overlay_groups``)."""
        with tracing.span("lncr.audio.overlay_groups"):
            cohorts: dict = {}
            for source, secs in pairs:
                starts = self._starts(secs)
                source = self._matched(source)
                n_src = int(source._buf.shape[0])
                cohorts.setdefault((_bucket(len(starts)), _bucket(n_src)),
                                   []).append((source._buf, n_src, starts))
            ordered = [g for _, grp in sorted(cohorts.items(),
                                              key=lambda kv: kv[0])
                       for g in grp]
            audio_ops.overlay_groups(self._buf, [g[0] for g in ordered],
                                     [g[1] for g in ordered],
                                     [g[2] for g in ordered])

    def cut(self, start, end, *, time_unit: str = "frame") -> None:
        """ApplyCutAudioClip (cpp:1265-1279) with the binding's second/frame
        conversion (pybind:614-629).

        Parity quirk: the reference binding converts seconds with the
        Python-cached sample rate (``_update_props`` runs only when a clip
        is made or wrapped, pybind:512-526), so after ``resample`` or
        ``apply_speed`` the conversion uses the stale rate."""
        if time_unit not in ("frame", "second"):
            raise ValueError("time_unit must be 'frame' or 'second'")
        if time_unit == "second":
            start = int(start * self._cached_rate)
            end = int(end * self._cached_rate)
        else:
            start = int(start)
            end = int(end)
        length = end - start
        self._buf = audio_ops.cut(self._buf, start, length)
        self._num_frames = length

    def apply_speed(self, speed: float) -> None:
        """ApplySpeedAudioClip (cpp:1281-1283): reinterpret the sample rate
        (i64 *= f64 truncates)."""
        self._sample_rate = int(self._sample_rate * speed)

    # ------------------------------------------------------------------ #
    # WAV serialisation (cpp:1165-1228)
    # ------------------------------------------------------------------ #
    def save_as_wav(self) -> bytes:
        """The clip as 16-bit PCM RIFF/WAVE bytes.  The samples are
        quantised on the clip's device; from the card they come back in
        one copy into pinned memory, and the header and the samples are
        joined into the output once the copy has ended: one allocation
        and one host copy of the samples a call, since each further
        buffer of the clip's size costs the host its page faults."""
        with tracing.span("lncr.audio.save_as_wav"):
            with tracing.span("lncr.audio.copy_out"):
                pcm = audio_ops.to_int16_device(self._buf)
                done = None
                if pcm.is_cuda:
                    host = torch.empty(pcm.shape, dtype=torch.int16,
                                       pin_memory=True)
                    host.copy_(pcm, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    host = pcm.contiguous()
            with tracing.span("lncr.audio.assemble"):
                n = pcm.numel() * 2
                AudioClip.save_as_wav.bytes += n
                header = b"RIFF" + struct.pack("<i", 36 + n) + b"WAVE"
                header += b"fmt " + struct.pack(
                    "<ihhiihh", 0x10, 1, self._channels, self._sample_rate,
                    self._sample_rate * self._channels * 2,
                    self._channels * 2, 16)
                header += b"data" + struct.pack("<i", n)
                if done is not None:
                    done.synchronize()
                return b"".join((header,
                                 memoryview(host.numpy()).cast("B")))


AudioClip.save_as_wav.bytes = 0


class Int16CreatedAudioClip(AudioClip):
    """CreateAudioClipFromInt16Buffer (cpp:1016-1034): /32768, taken on
    the clip's device (exact: a power of two)."""

    def __init__(self, sample_rate: int, channels: int,
                 data: typing.Iterable[int], *, device="cuda"):
        arr = np.asarray(data, dtype=np.int16)
        num_frames = arr.size // channels
        pcm = torch.tensor(arr.reshape(num_frames, channels),
                           device=as_device(device))
        self._init_from_device(
            sample_rate, channels,
            pcm.to(config.default_dtype()) * (1.0 / 32768.0))


class PtrCreatedAudioClip(AudioClip):
    """Parity alias for pointer-wrapped clips (pybind:656-659)."""

    def __init__(self, clip: AudioClip):
        self.__dict__.update(clip.__dict__)
        # wrapping runs _update_props in the reference (pybind:658-659)
        self._cached_rate = self._sample_rate
