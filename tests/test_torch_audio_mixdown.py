"""The port's mixdown against the benchmark's plain reference
(``bench_torch/references/audio_mix.py``: upstream's overlay and int16
conversion in float64, slice adds, no FFT) on the CPU: ``clone``,
``overlay_many`` and ``save_as_wav`` through the port are within one
level of it on every sample, on the FFT route (the benchmark cell's CPU
cut: 64 events of a 0.5 s sound onto a 4 s clip) and the scatter route
(16 events), in float32 and float64, with events cut short and dropped
at the clip's end.  The reference in bfloat16, the cell's control, fails
the same comparison."""

import io
import wave

import numpy as np
import pytest
import torch

import libnativecpurenderer_tpu_torch as P
from bench_torch.references import audio_mix as ref
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch.ops import audio_ops

torch.set_num_threads(1)

RATE = 44100
ROWS, SOUND_ROWS = 4 * RATE, RATE // 2          # 4.0 s and 0.5 s
FIRST_S, LAST_S = 0.05, 4.2                      # past the clip's end
EVENTS = {"fft": 64, "scatter": 16}              # buckets 64 and 16


@pytest.fixture(autouse=True)
def port_default_dtype():
    prev = pconfig.default_dtype()
    yield
    pconfig.set_default_dtype(prev)


def inputs(route):
    """The base clip, the sound (standard-normal noise x 0.05 and x 0.1)
    and sorted offsets over 0.05-4.2 s."""
    rng = np.random.default_rng(17)
    base = rng.standard_normal((ROWS, 2)) * 0.05
    sound = rng.standard_normal((SOUND_ROWS, 2)) * 0.1
    offsets = np.sort(rng.uniform(FIRST_S, LAST_S, EVENTS[route]))
    return base, sound, offsets


def wav_pcm(wav: bytes) -> torch.Tensor:
    with wave.open(io.BytesIO(wav)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) \
            == (2, 2, RATE)
        raw = w.readframes(w.getnframes())
    return torch.from_numpy(np.frombuffer(raw, "<i2").reshape(-1, 2).copy())


def port_mix(route, dtype):
    """The port's int16 samples and the float64 reference's, of the same
    clip and sound as the port holds them."""
    pconfig.set_default_dtype(dtype)
    base, sound, offsets = inputs(route)
    clip = P.AudioClip._from_array(RATE, 2, base, device="cpu")
    sfx = P.AudioClip._from_array(RATE, 2, sound, device="cpu")
    fft0 = audio_ops.overlay_many.fft
    mixed = clip.clone()
    mixed.overlay_many(sfx, offsets)
    assert (audio_ops.overlay_many.fft - fft0) == (route == "fft")
    got = wav_pcm(mixed.save_as_wav())
    want = ref.mix(torch.from_numpy(clip.numpy()),
                   torch.from_numpy(sfx.numpy()), offsets, RATE)
    return got, want


def levels_off(got, want) -> int:
    return int((got.int() - want.int()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("route", ["fft", "scatter"])
def test_port_matches_the_reference(route, dtype):
    got, want = port_mix(route, dtype)
    assert got.shape == want.shape == (ROWS, 2)
    assert levels_off(got, want) <= 1
    # the mix is not its base, and the events reach the clip's last rows
    starts = ref.start_frames(inputs(route)[2], RATE)
    assert (starts >= ROWS).any() and ((starts < ROWS)
                                       & (starts + SOUND_ROWS > ROWS)).any()
    base = ref.mix(torch.from_numpy(inputs(route)[0]),
                   torch.zeros(1, 2), [], RATE)
    assert levels_off(want[-100:], base[-100:]) > 1


@pytest.mark.parametrize("route", ["fft", "scatter"])
def test_bfloat16_control_fails_the_comparison(route):
    base, sound, offsets = inputs(route)
    b32 = torch.from_numpy(base).float()
    s32 = torch.from_numpy(sound).float()
    want = ref.mix(b32, s32, offsets, RATE)
    control = ref.mix(b32, s32, offsets, RATE, torch.bfloat16)
    assert levels_off(control, want) > 1


def test_reference_is_upstreams_loop():
    """The reference's slice adds against upstream's sample loop, an event
    cut short and one dropped at the end."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal((50, 2)) * 0.3
    sound = rng.standard_normal((20, 2)) * 0.4
    offsets = [0.0, 0.013, 0.0449, 0.05, 0.07]      # frames 0, 13, 44, 50, 70
    out = base.copy()
    for s in (np.asarray(offsets) * 1000).astype(np.int64):
        for i in range(20):
            if s + i < 50:
                out[s + i] += sound[i]
    want = (np.clip(out, -1, 1) * 32767).astype(np.int16)
    got = ref.mix(torch.from_numpy(base), torch.from_numpy(sound), offsets,
                  1000)
    np.testing.assert_array_equal(got.numpy(), want)
