"""The audio mixdown system: upstream's demo mixdown on the port's audio
engine, one mix a frame.  Set-up puts the base clip and the sound on the
device as ``AudioClip``s made from the seed; each ``submit`` runs the
public path, ``clone``, ``overlay_many`` (the FFT route at the demo's
size: an impulse train, rffts, their product, an irfft, the add) and
``save_as_wav`` (the int16 quantise on the device, the pinned copy,
the RIFF bytes on the host), and hands the sink the int16 (N, 2)
samples of the WAV's data chunk.  Set-up first reads the port's audio
counters (``System.counters``): a port without them cannot run the
cell, and fails there, before anything is made.

The reference (``references/audio_mix``) overlays the same float32 clip
and sound in float64 with slice adds, no FFT; its control in bfloat16.
"""

from __future__ import annotations

import json
import struct
import sys
from unittest import mock

import numpy as np
import torch

from ..harness import traffic as traffic_mod
from ..references import audio_mix as audio_ref
from ..rooflines import audio_mix as roof

LIBRARY = None               # the port has no library of its own here
BASE_GAIN, SOUND_GAIN = 0.05, 0.1
REPLAY_MIXES = 16            # at least, through a fresh clip
ALTER_ROW, ALTER_SAMPLES = 4096, 1024
SPANS = ("lncr.audio.overlay_many", "lncr.audio.fft",
         "lncr.audio.save_as_wav", "lncr.audio.copy_out",
         "lncr.audio.assemble")


def wav_samples(wav: bytes) -> np.ndarray:
    """The int16 (N, C) samples of a 16-bit PCM RIFF/WAVE's data chunk,
    found by walking its chunks."""
    if wav[:4] != b"RIFF" or wav[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE")
    at, channels = 12, None
    while at + 8 <= len(wav):
        tag, size = wav[at:at + 4], struct.unpack("<I", wav[at + 4:at + 8])[0]
        body = at + 8
        if tag == b"fmt ":
            fmt, channels, _, _, _, bits = struct.unpack(
                "<hhiihh", wav[body:body + 16])
            if fmt != 1 or bits != 16:
                raise ValueError(f"not 16-bit PCM: format {fmt}, {bits} bits")
        elif tag == b"data":
            if channels is None:
                raise ValueError("a data chunk before the fmt chunk")
            return np.frombuffer(wav, "<i2", count=size // 2,
                                 offset=body).reshape(-1, channels)
        at = body + size + (size & 1)
    raise ValueError("no data chunk")


class System:
    record = None                # a mix is its offsets: nothing recorded

    def __init__(self, config: dict, mix: dict, seed: int, device, sink):
        from libnativecpurenderer_tpu_torch import config as port_config
        self.counters()
        dtype = getattr(torch, config["dtype"])
        if port_config.default_dtype() != dtype:
            raise ValueError(f"the port's default dtype is "
                             f"{port_config.default_dtype()}, the "
                             f"configuration states {dtype}")
        for key in ("events", "first_s", "last_s"):
            if mix[key] != config[key]:
                raise ValueError(f"the mix's {key} {mix[key]} is not the "
                                 f"configuration's {config[key]}")
        self.rate, self.channels = config["sample_rate"], config["channels"]
        rows, n = config["clip_rows"], config["sound_rows"]
        if (rows, n) != (round(config["clip_s"] * self.rate),
                         round(config["sound_s"] * self.rate)):
            raise ValueError("clip_rows or sound_rows is not its seconds "
                             "times the rate")
        gen = torch.Generator(device=device)
        gen.manual_seed(int(traffic_mod.seed_rng(seed, 3).integers(1 << 62)))
        noise = torch.randn((rows + n) * self.channels, generator=gen,
                            device=device, dtype=dtype)
        # the clip and sound as the program holds them, kept for the
        # reference and the replay
        self.base_buf = noise[:rows * self.channels].view(
            rows, self.channels) * BASE_GAIN
        self.sound_buf = noise[rows * self.channels:].view(
            n, self.channels) * SOUND_GAIN
        del noise
        self._clips()
        self.sink = sink
        self.batch = config["batch"]

    def _clips(self) -> None:
        from libnativecpurenderer_tpu_torch import AudioClip
        self.base = AudioClip._from_device(self.rate, self.channels,
                                           self.base_buf)
        self.sound = AudioClip._from_device(self.rate, self.channels,
                                            self.sound_buf)

    @staticmethod
    def counters() -> dict:
        """The port's audio counters by name; raises ``RuntimeError``
        naming those it lacks."""
        from libnativecpurenderer_tpu_torch import AudioClip
        from libnativecpurenderer_tpu_torch.ops import audio_ops
        where = {"overlay_many.fft": (audio_ops.overlay_many, "fft"),
                 "overlay_many.events": (audio_ops.overlay_many, "events"),
                 "save_as_wav.bytes": (AudioClip.save_as_wav, "bytes")}
        missing = [k for k, (f, a) in where.items() if not hasattr(f, a)]
        if missing:
            raise RuntimeError(f"the port lacks the audio counters {missing}"
                               f", which this cell's traced run reads")
        return {k: getattr(f, a) for k, (f, a) in where.items()}

    def _mix(self, offsets) -> bytes:
        clip = self.base.clone()
        clip.overlay_many(self.sound, offsets)
        return clip.save_as_wav()

    def submit(self, offsets) -> None:
        self.sink.put_frame_u8(wav_samples(self._mix(offsets)))

    def finish(self) -> None:
        pass                     # each submit delivers its mix

    def close(self) -> None:
        self.base = self.sound = None

    def reference(self, offsets, device, control=False):
        """The reference's int16 samples of one mix (the control's with
        ``control``: in bfloat16)."""
        dtype = torch.bfloat16 if control else torch.float64
        return audio_ref.mix(self.base_buf.to(device),
                             self.sound_buf.to(device), offsets, self.rate,
                             dtype)

    def work(self, inputs, device) -> dict:
        """The least work of these mixes, counted from their offsets
        (``rooflines/audio_mix``), and a replay's span totals and
        counters: after one warm mix (the check has emptied the device's
        cache, so the first mix allocates anew), at least
        ``REPLAY_MIXES`` mixes of these inputs in turn through fresh
        clips, with tracing on (ranges off) and off again after, logged
        on standard error."""
        rows, n = self.base_buf.shape[0], self.sound_buf.shape[0]
        counts = {"mixes": len(inputs), "rows": rows,
                  "channels": self.channels, "sound_rows": n,
                  "sample_bytes": self.base_buf.element_size(),
                  "event_rows": sum(roof.event_rows(o, self.rate, rows, n)
                                    for o in inputs)}
        replay = self._replay(inputs)
        print(f"audio replay: {json.dumps(replay)}", file=sys.stderr,
              flush=True)
        return {"audio_mix": counts, "audio_replay": replay}

    def _replay(self, inputs) -> dict:
        from libnativecpurenderer_tpu_torch import tracing
        mixes = max(REPLAY_MIXES, len(inputs))
        self._clips()
        self._mix(inputs[0])
        before = self.counters()
        tracing.reset()
        tracing.ranges(False)
        tracing.enable(True)
        try:
            for i in range(mixes):
                self._mix(inputs[i % len(inputs)])
            totals = tracing.totals()
            after = self.counters()
        finally:
            tracing.enable(False)
            tracing.reset()
            self.close()
        return {"mixes": mixes,
                "spans": {k: v for k, v in totals.items() if k in SPANS},
                "counters": {k: after[k] - before[k] for k in after}}


def fault(kind: str):
    """``faults.KINDS``' ``kind`` planted in the audio engine:
    ``overlay_many`` does nothing, so a mix is its base (``unchanged``);
    every other event is left out (``half``); or the bytes of a block of
    1,024 int16 samples of every mix flipped where they are quantised
    (``altered``)."""
    from libnativecpurenderer_tpu_torch import AudioClip
    from libnativecpurenderer_tpu_torch.ops import audio_ops
    if kind == "unchanged":
        return mock.patch.object(AudioClip, "overlay_many",
                                 lambda self, source, start_seconds: None)
    if kind == "half":
        real = AudioClip.overlay_many

        def every_other(self, source, start_seconds):
            real(self, source, np.asarray(start_seconds)[::2])
        return mock.patch.object(AudioClip, "overlay_many", every_other)
    real_q = audio_ops.to_int16_device

    def altered(buf):
        pcm = real_q(buf).clone()
        rows = ALTER_SAMPLES // pcm.shape[1]
        pcm[ALTER_ROW:ALTER_ROW + rows] ^= 0x5555
        return pcm
    return mock.patch.object(audio_ops, "to_int16_device", altered)


SMALL_CLIP_S, SMALL_EVENTS = 4.0, 64
SMALL_FIRST_S, SMALL_LAST_S = 0.05, 4.2


def small(cell, **variant):
    """The cell cut for the CPU tests, on the FFT route still: 64 events
    of the 0.5 s sound over 0.05-4.2 s onto a 4.0 s clip (a bucket of 64
    x 22,050 rows > 2^20, m = 2^18; events past the end dropped, those
    before it cut short).  The cell has no variant.  Returns the
    configuration, mix and limits, and the seconds of a CPU window that
    holds at least two mixes."""
    if variant:
        raise ValueError(f"the audio cell has no variant {sorted(variant)}")
    ends = dict(events=SMALL_EVENTS, first_s=SMALL_FIRST_S,
                last_s=SMALL_LAST_S)
    config = dict(cell.config, clip_s=SMALL_CLIP_S,
                  clip_rows=round(SMALL_CLIP_S * cell.config["sample_rate"]),
                  **ends)
    return config, dict(cell.mix, **ends), cell.limits, 0.5
