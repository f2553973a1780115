"""The MIDI mixer system: upstream's ``src/hjm_mixer.py`` as its web
service runs it (``src/hjm_mixer_server.py``), on the port's
``apps/hjm_mixer`` with a resident bank, one song a frame.  Set-up first
reads the port's mixer counters (``System.counters``: a port without
them, or without ``hjm_mixer.Bank`` and ``hjm_mixer.mix``, cannot run
the cell, and fails there, before anything is made), writes the seeded
ha/ji/mi banks to a temporary directory as 48 kHz s16 stereo WAVs and
builds the port's ``Bank`` of every file on the device: the service
starting.  Each ``submit`` runs ``hjm_mixer.mix`` on the song's bytes
(the SMF parse, the note pairing, the round-robin grouping, a silent
target and ``AudioClip.overlay_groups``: the cohort sort and one slice
add an event run) and ``save_as_wav``, and hands the sink the int16
(N, 2) samples of the WAV's data chunk.

The reference (``references/hjm_mix``) mixes the generator's notes from
the same int16 bank files in float64; its control in bfloat16.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import wave
from collections import defaultdict
from unittest import mock

import numpy as np

from ..harness import traffic as traffic_mod
from ..references import hjm_mix as ref
from ..rooflines import hjm_mix as roof
from .audio_mix import fault as audio_fault
from .audio_mix import wav_samples

LIBRARY = None               # the port has no library of its own here
BANK_NAMES = ("ha", "ji", "mi")
BANK_FILES = range(12, 144)
BANK_SALT = 7
REPLAY_MIXES = 16            # at least
SPANS = ("lncr.hjm.notes", "lncr.audio.overlay_groups",
         "lncr.audio.save_as_wav", "lncr.audio.copy_out",
         "lncr.audio.assemble")


def bank_pcm(config: dict, seed: int) -> dict:
    """The seeded banks' int16 (frames, 2) samples by (instrument, file):
    a decaying tone of the file's note (instrument i: i + 1 harmonics,
    decay 3 + i a second), the right channel 0.9 of the left, and a
    little seeded noise, after ``chip_smoke.write_bank``'s recipe."""
    rate = int(config["bank_rate"])
    frames = round(config["bank_seconds"] * rate)
    rng = traffic_mod.seed_rng(seed, BANK_SALT)
    t = np.arange(frames) / rate
    out = {}
    for bi in range(len(BANK_NAMES)):
        env = 0.25 * np.exp(-t * (3.0 + bi))
        for f in BANK_FILES:
            hz = 440.0 * 2 ** ((f - 69) / 12)
            tone = sum(np.sin(2 * np.pi * hz * (h + 1) * t) / (h + 1)
                       for h in range(bi + 1)) * env
            pcm = np.stack([tone, tone * 0.9], 1)
            pcm += rng.standard_normal(pcm.shape) * 0.002
            out[(bi, f)] = (np.clip(pcm, -1, 1) * 32767).astype("<i2")
    return out


def write_bank(root: str, pcm: dict, rate: int) -> None:
    """The banks as ``root/<name>/<file>.wav``, 16-bit PCM at ``rate``."""
    for bi, name in enumerate(BANK_NAMES):
        os.makedirs(os.path.join(root, name))
    for (bi, f), x in pcm.items():
        with wave.open(os.path.join(root, BANK_NAMES[bi], f"{f}.wav"),
                       "wb") as w:
            w.setnchannels(x.shape[1])
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(x.tobytes())


class System:
    record = None                # a mix is its song's bytes: nothing recorded

    def __init__(self, config: dict, mix: dict, seed: int, device, sink):
        from libnativecpurenderer_tpu_torch import config as port_config
        import torch
        self.counters()
        dtype = getattr(torch, config["dtype"])
        if port_config.default_dtype() != dtype:
            raise ValueError(f"the port's default dtype is "
                             f"{port_config.default_dtype()}, the "
                             f"configuration states {dtype}")
        self.rate, self.channels = config["sample_rate"], config["channels"]
        self.bank_rate = int(config["bank_rate"])
        self.request = (config["min_note"], config["max_note"],
                        config["dnote"], config["offset"])
        self.device = device
        self.sample_bytes = torch.finfo(dtype).bits // 8
        self.pcm = bank_pcm(config, seed)
        self._dir = tempfile.TemporaryDirectory(prefix="hjm_bank_")
        write_bank(self._dir.name, self.pcm, self.bank_rate)
        self._bank()
        self.decodes_at_setup = self._decodes()
        self.decodes_to_close = None
        self._ref_clips: dict = {}
        self.sink = sink
        self.batch = config["batch"]

    def _bank(self) -> None:
        from libnativecpurenderer_tpu_torch.apps import hjm_mixer
        self.bank = hjm_mixer.Bank(self._dir.name, self.rate, self.channels,
                                   self.device).preload()

    @staticmethod
    def _decodes() -> int:
        from libnativecpurenderer_tpu_torch.apps import hjm_mixer
        return hjm_mixer.Bank.decodes

    @staticmethod
    def counters() -> dict:
        """The port's mixer counters by name; raises ``RuntimeError``
        naming those it lacks (and the mixer's ``Bank`` or ``mix``)."""
        from libnativecpurenderer_tpu_torch import AudioClip
        from libnativecpurenderer_tpu_torch.apps import hjm_mixer
        from libnativecpurenderer_tpu_torch.ops import audio_ops
        groups = audio_ops.overlay_groups
        where = {"overlay_groups.groups": (groups, "groups"),
                 "overlay_groups.events": (groups, "events"),
                 "overlay_groups.segments": (groups, "segments"),
                 "hjm_mixer.Bank.decodes": (
                     getattr(hjm_mixer, "Bank", None), "decodes"),
                 "save_as_wav.bytes": (AudioClip.save_as_wav, "bytes")}
        missing = [k for k, (f, a) in where.items() if not hasattr(f, a)]
        if not callable(getattr(hjm_mixer, "mix", None)):
            missing.append("hjm_mixer.mix")
        if missing:
            raise RuntimeError(f"the port lacks the mixer's {missing}, "
                               f"which this cell runs and its traced run "
                               f"reads")
        return {k: getattr(f, a) for k, (f, a) in where.items()}

    def _mix(self, song) -> bytes:
        from libnativecpurenderer_tpu_torch.apps import hjm_mixer
        return hjm_mixer.mix(song["smf"], self.bank,
                             *self.request).save_as_wav()

    def submit(self, song) -> None:
        self.sink.put_frame_u8(wav_samples(self._mix(song)))

    def finish(self) -> None:
        pass                     # each submit delivers its mix

    def close(self) -> None:
        if self.decodes_to_close is None:
            self.decodes_to_close = self._decodes() - self.decodes_at_setup
        self.bank = None

    def _events(self, song) -> tuple:
        return ref.events(song["onsets_s"], song["notes"], *self.request,
                          self.rate)

    def reference(self, song, device, control=False):
        """The reference's int16 samples of one mix (the control's with
        ``control``: in bfloat16), from the bank files' int16 samples."""
        import torch
        dtype = torch.bfloat16 if control else torch.float64

        def clip_of(inst, f):
            key = (inst, f, dtype, str(device))
            if key not in self._ref_clips:
                self._ref_clips[key] = ref.resample(
                    self.pcm[(inst, f)], self.bank_rate, self.rate, dtype,
                    device)
            return self._ref_clips[key]

        evs, rows = self._events(song)
        return ref.mix(evs, rows, self.channels, clip_of, dtype, device)

    def work(self, inputs, device) -> dict:
        """The least work of these mixes, counted from the generator's
        onsets (``rooflines/hjm_mix``), and a replay's span totals and
        counters (under ``audio_replay``, the key the audio engine's span
        metrics read): the bank built again (the check freed it), one warm
        mix, then at least ``REPLAY_MIXES`` mixes of these songs in turn
        with tracing on (ranges off) and off again after, logged on
        standard error with the files decoded between set-up and the
        end of the timed and profiled windows."""
        frames = int(self.pcm[(0, BANK_FILES[0])].shape[0]
                     / self.bank_rate * self.rate)
        samples = event_samples = clip_samples = 0
        for song in inputs:
            evs, rows = self._events(song)
            samples += rows * self.channels
            event_samples += self.channels * roof.event_rows(
                [s for _, _, s in evs], rows, frames)
            by_clip = defaultdict(list)
            for inst, f, s in evs:
                by_clip[(inst, f)].append(s)
            clip_samples += self.channels * sum(
                roof.clip_rows_read(st, rows, frames)
                for st in by_clip.values())
        counts = {"mixes": len(inputs), "samples": samples,
                  "clip_samples": clip_samples,
                  "event_samples": event_samples,
                  "sample_bytes": self.sample_bytes}
        self._ref_clips.clear()
        replay = self._replay(inputs)
        replay["decodes_in_run"] = self.decodes_to_close
        print(f"hjm replay: {json.dumps(replay)}", file=sys.stderr,
              flush=True)
        return {"hjm_mix": counts, "audio_replay": replay}

    def _replay(self, inputs) -> dict:
        from libnativecpurenderer_tpu_torch import tracing
        mixes = max(REPLAY_MIXES, len(inputs))
        self._bank()
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
            self._dir.cleanup()
        return {"mixes": mixes,
                "spans": {k: v for k, v in totals.items() if k in SPANS},
                "counters": {k: after[k] - before[k] for k in after}}


def fault(kind: str):
    """``faults.KINDS``' ``kind`` planted in the mixer:
    ``overlay_groups`` does nothing, so a mix is its silent target
    (``unchanged``); every other group of a mix is left out (``half``);
    or the bytes of a block of 1,024 int16 samples of every mix flipped
    where they are quantised (``altered``, as the audio mixdown's)."""
    from libnativecpurenderer_tpu_torch import AudioClip
    if kind == "unchanged":
        return mock.patch.object(AudioClip, "overlay_groups",
                                 lambda self, pairs: None)
    if kind == "half":
        real = AudioClip.overlay_groups

        def every_other(self, pairs):
            real(self, list(pairs)[::2])
        return mock.patch.object(AudioClip, "overlay_groups", every_other)
    return audio_fault(kind)


SMALL_NOTES, SMALL_GAPS, SMALL_BANK_S = 64, [30, 90], 0.1


def small(cell, **variant):
    """The cell cut for the CPU tests: songs of 64 notes (gaps of 30-90
    ticks, the tempo changing at notes 21 and 42; ~3 s, a ~4 s target)
    and bank files of 0.1 s, the whole 3 x 132 of them.  The cell has no
    variant.  Returns the configuration, mix and limits, and the seconds
    of a CPU window that holds at least two mixes."""
    if variant:
        raise ValueError(f"the mixer cell has no variant {sorted(variant)}")
    tempos = [list(t) for t in cell.mix["tempos"]]
    tempos = [[0, tempos[0][1]], [21, tempos[1][1]], [42, tempos[2][1]]]
    mix = dict(cell.mix, notes=SMALL_NOTES, gap_ticks=SMALL_GAPS,
               tempos=tempos)
    return dict(cell.config, bank_seconds=SMALL_BANK_S), mix, \
        cell.limits, 0.5
