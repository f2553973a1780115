"""The port's audio engine (``AudioClip`` and ``ops/audio_ops``) on the CPU.

Two halves: the 20 golden-waveform tests of ``test_audio_golden.py`` run
against the port, with the same NumPy float64 models of the reference's
sample loops and the same tolerances; then the port against the JAX
package on the same seeded clips, bit for bit on every op and route but
the FFT route of ``overlay_many`` (``torch.fft`` and JAX's FFT round
differently; held at JAX's own ``atol=1e-9`` in float64).  The pins: the
route choice at the bucketed threshold, the order of the overlay sums
within a call and across ``overlay_groups``' cohorts, JAX's
``mode="drop"`` for negative and past-end starts, ``cut``'s
``dynamic_slice`` clamp, the stale-rate quirk and the WAV bytes.
"""

import io
import struct
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libnativecpurenderer_tpu as R
import libnativecpurenderer_tpu_torch as P
from libnativecpurenderer_tpu import config as jconfig
from libnativecpurenderer_tpu.ops import audio_ops as jops
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch import interop
from libnativecpurenderer_tpu_torch.ops import audio_ops as pops

torch.set_num_threads(1)

DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


@pytest.fixture(autouse=True)
def port_f64_default():
    """Clips hold their samples in the default dtype; the JAX conftest
    runs with a float64 default, and so does the port here."""
    prev = pconfig.default_dtype()
    pconfig.set_default_dtype(torch.float64)
    yield
    pconfig.set_default_dtype(prev)


def use_dtype(name):
    """Both packages' default dtype set to ``name`` (the fixtures restore
    them)."""
    jconfig.set_default_dtype(DTYPES[name][0])
    pconfig.set_default_dtype(DTYPES[name][1])


def pclip(rate, channels, arr):
    return P.AudioClip._from_array(rate, channels, arr, device="cpu")


def jclip(rate, channels, arr):
    return R.AudioClip._from_array(rate, channels, arr)


def pair(rate, channels, arr):
    """The same samples as a JAX clip and a port clip."""
    return jclip(rate, channels, arr), pclip(rate, channels, arr)


def assert_same_bits(port, jax):
    a = np.ascontiguousarray(port.numpy() if hasattr(port, "numpy")
                             and not isinstance(port, np.ndarray) else port)
    b = np.ascontiguousarray(np.asarray(jax.numpy() if hasattr(jax, "_buf")
                                        else jax))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                      a.dtype, b.dtype)
    ua = a.view(np.uint64 if a.itemsize == 8 else np.uint32)
    ub = b.view(np.uint64 if b.itemsize == 8 else np.uint32)
    bad = int((ua != ub).sum())
    assert bad == 0, f"{bad} samples differ, max {np.abs(a - b).max()}"


# --------------------------------------------------------------------------
# mirrors of tests/test_audio_golden.py
# --------------------------------------------------------------------------

def golden_resample(buf, old_rate, new_rate, new_channels):
    """ApplyResampleAudioClip (cpp:1063-1120) as literal numpy f64."""
    num_frames, channels = buf.shape
    dur = num_frames / old_rate
    new_num = int(dur * new_rate)
    out = np.zeros((new_num, new_channels), np.float64)
    for i in range(new_num):
        sec_t = i / new_rate
        old_idx = sec_t * old_rate
        lo = int(np.floor(old_idx))
        hi = int(np.ceil(old_idx))
        bound = num_frames - channels  # sic: mixes frames & channels
        lo = max(0, min(lo, bound - 1))
        hi = max(0, min(hi, bound - 1))
        frac = old_idx - lo
        if channels == new_channels:
            for c in range(channels):
                v0 = buf[lo, c]
                v1 = buf[hi, c]
                out[i, c] = v0 + (v1 - v0) * frac
        else:
            s0 = buf[lo].sum() / channels
            s1 = buf[hi].sum() / channels
            out[i, :] = s0 + (s1 - s0) * frac
    return out


def golden_overlay(target, source, start):
    out = target.copy()
    for i in range(source.shape[0]):
        if start + i >= target.shape[0]:
            break
        if start + i < 0:
            continue
        out[start + i] += source[i]
    return out


def test_create_and_props():
    data = [0.1, -0.1, 0.2, -0.2, 0.3, -0.3]
    clip = P.AudioClip(44100, 2, data, device="cpu")
    assert clip.sample_rate == 44100
    assert clip.channels == 2
    assert clip.num_frames == 3
    assert abs(clip.duration - 3 / 44100) < 1e-15
    np.testing.assert_array_equal(clip.numpy().reshape(-1), data)


def test_int16_create():
    data = np.array([16384, -16384, 32767, -32768], np.int16)
    clip = P.Int16CreatedAudioClip(8000, 2, data, device="cpu")
    np.testing.assert_allclose(clip.numpy().reshape(-1),
                               data.astype(np.float64) / 32768.0)


def test_silent_and_gain():
    clip = P.AudioClip.slient(1000, 2, 50, device="cpu")
    assert clip.num_frames == 50
    assert np.all(clip.numpy() == 0)
    clip2 = P.AudioClip(1000, 1, [0.5, -0.5, 0.25], device="cpu")
    clip2.apply_volume_gain(0.5)
    np.testing.assert_allclose(clip2.numpy().reshape(-1),
                               [0.25, -0.25, 0.125])


def test_overlay_frames_and_truncation():
    rng = np.random.default_rng(0)
    t = rng.standard_normal((100, 2)) * 0.1
    s = rng.standard_normal((30, 2)) * 0.1
    target = pclip(1000, 2, t)
    source = pclip(1000, 2, s)
    target.overlay(source, 85)  # truncates at end (cpp:1146)
    np.testing.assert_allclose(target.numpy(), golden_overlay(t, s, 85),
                               atol=1e-15)


def test_overlay_seconds():
    rng = np.random.default_rng(1)
    t = rng.standard_normal((1000, 1))
    s = rng.standard_normal((10, 1))
    target = pclip(100, 1, t)
    source = pclip(100, 1, s)
    target.overlay(source, 1.234, time_unit="second")
    np.testing.assert_allclose(target.numpy(),
                               golden_overlay(t, s, int(1.234 * 100)),
                               atol=1e-15)


def test_overlay_mismatch_raises():
    a = P.AudioClip.slient(1000, 2, 10, device="cpu")
    b = P.AudioClip.slient(2000, 2, 10, device="cpu")
    with pytest.raises(ValueError):
        a.overlay(b, 0)
    c = P.AudioClip.slient(1000, 1, 10, device="cpu")
    with pytest.raises(ValueError):
        a.overlay(c, 0)


def test_overlay_auto_resample():
    rng = np.random.default_rng(2)
    t = np.zeros((200, 2))
    s = rng.standard_normal((50, 1))
    target = pclip(2000, 2, t)
    source = pclip(1000, 1, s)
    target.overlay(source, 10, auto_resample=True)
    rs = golden_resample(s, 1000, 2000, 2)
    np.testing.assert_allclose(target.numpy(), golden_overlay(t, rs, 10),
                               atol=1e-12)


def test_overlay_many_matches_sequential():
    rng = np.random.default_rng(3)
    t = rng.standard_normal((500, 2)) * 0.1
    s = rng.standard_normal((40, 2)) * 0.1
    a = pclip(100, 2, t.copy())
    b = pclip(100, 2, t.copy())
    src = pclip(100, 2, s)
    secs = [0.1, 0.5, 1.23, 4.9]
    for sec in secs:
        a.overlay(src, sec, time_unit="second")
    b.overlay_many(src, secs)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


def test_resample_rate_same_channels():
    rng = np.random.default_rng(4)
    s = rng.standard_normal((997, 2))
    clip = pclip(44100, 2, s)
    clip.resample(48000, 2)
    want = golden_resample(s, 44100, 48000, 2)
    assert clip.num_frames == want.shape[0]
    assert clip.sample_rate == 48000
    np.testing.assert_allclose(clip.numpy(), want, atol=1e-12)


def test_resample_channel_mix():
    rng = np.random.default_rng(5)
    s = rng.standard_normal((300, 2))
    clip = pclip(8000, 2, s)
    clip.resample(8000, 1)  # same rate, channel downmix still resamples
    want = golden_resample(s, 8000, 8000, 1)
    np.testing.assert_allclose(clip.numpy(), want, atol=1e-12)


def test_resample_noop():
    rng = np.random.default_rng(6)
    s = rng.standard_normal((100, 2))
    clip = pclip(44100, 2, s)
    clip.resample(44100, 2)
    np.testing.assert_array_equal(clip.numpy(), s)


def test_cut():
    rng = np.random.default_rng(7)
    s = rng.standard_normal((100, 2))
    clip = pclip(1000, 2, s)
    clip.cut(10, 40)
    np.testing.assert_array_equal(clip.numpy(), s[10:40])
    assert clip.num_frames == 30
    # cut beyond the end: the reference leaves the tail uninitialised;
    # the port zero-fills, as the JAX package does
    clip2 = pclip(1000, 2, s)
    clip2.cut(90, 120)
    out = clip2.numpy()
    np.testing.assert_array_equal(out[:10], s[90:])
    assert np.all(out[10:] == 0)


def test_cut_seconds():
    s = np.arange(200, dtype=np.float64).reshape(100, 2)
    clip = pclip(100, 2, s)
    clip.cut(0.1, 0.4, time_unit="second")
    np.testing.assert_array_equal(clip.numpy(), s[10:40])


def test_apply_speed():
    clip = P.AudioClip.slient(44100, 2, 100, device="cpu")
    clip.apply_speed(1.5)
    assert clip.sample_rate == int(44100 * 1.5)


def test_clone_independent():
    s = np.ones((10, 1))
    a = pclip(100, 1, s)
    b = a.clone()
    b.apply_volume_gain(2.0)
    assert np.all(a.numpy() == 1.0)
    assert np.all(b.numpy() == 2.0)


def test_save_as_wav_layout():
    # exact RIFF layout per cpp:1165-1228
    clip = P.AudioClip(8000, 2, [0.5, -0.5, 2.0, -2.0], device="cpu")
    wav = clip.save_as_wav()
    assert wav[:4] == b"RIFF"
    assert wav[8:12] == b"WAVE"
    assert wav[12:16] == b"fmt "
    assert struct.unpack("<i", wav[4:8])[0] == len(wav) - 8
    fmt, ch, rate, brate, align, bits = struct.unpack("<hhiihh", wav[20:36])
    assert (fmt, ch, rate, bits) == (1, 2, 8000, 16)
    assert wav[36:40] == b"data"
    pcm = np.frombuffer(wav[44:], np.int16)
    # (i16)(clamp(v)*32767) with C truncation toward zero
    np.testing.assert_array_equal(pcm, [16383, -16383, 32767, -32767])


def test_save_as_wav_multichunk_identical():
    # a clip of several MB of samples: the same quantised values and
    # header as one serialisation
    rng = np.random.default_rng(9)
    s = np.clip(rng.standard_normal((700_000, 2)) * 0.4, -1, 1)
    clip = pclip(44100, 2, s)
    wav = clip.save_as_wav()
    n = struct.unpack("<i", wav[40:44])[0]
    assert n == 700_000 * 2 * 2 and len(wav) == 44 + n
    pcm = np.frombuffer(wav[44:], "<i2").reshape(-1, 2)
    want = np.trunc(np.clip(s, -1, 1) * 32767).astype(np.int16)
    np.testing.assert_array_equal(pcm, want)


def test_wav_roundtrip_via_stdlib():
    rng = np.random.default_rng(8)
    s = np.clip(rng.standard_normal((500, 2)) * 0.3, -1, 1)
    clip = pclip(22050, 2, s)
    w = wave.open(io.BytesIO(clip.save_as_wav()))
    assert w.getnchannels() == 2
    assert w.getframerate() == 22050
    assert w.getnframes() == 500


def test_overlay_many_fft_path_drops_out_of_range():
    """FFT-route overlay_many drops events starting past the target's end
    (cpp:1146): left in the impulse train they would wrap the circular
    convolution into the head of the mix."""
    rng = np.random.default_rng(9)
    N, n, n_ev = 10000, 20000, 64            # n_ev * n > 1<<20 -> FFT route
    t = rng.standard_normal((N, 2)) * 0.1
    s = rng.standard_normal((n, 2)) * 0.1
    starts = rng.integers(0, N - 1, n_ev)
    starts[0] = 15000                         # past the end: must vanish
    starts[1] = N                             # exactly at the end
    starts[2] = N + n                         # far past

    out = pops.overlay_many(torch.tensor(t), torch.tensor(s), starts).numpy()

    golden = t.copy()
    for st in starts:
        if st >= N:
            continue
        golden[st:] += s[: N - st]
    np.testing.assert_allclose(out, golden, atol=1e-9)


def test_overlay_groups_matches_sequential():
    # overlay_groups == sequential overlay_many, exactly, when the groups
    # touch disjoint sample ranges; in-range/out-of-range drops and
    # distinct clip lengths and counts ride the same cohorts
    rng = np.random.default_rng(11)
    base = rng.standard_normal((30_000, 2)) * 0.1
    pairs = []
    off = 0
    for k, (ln, ev) in enumerate([(300, 3), (121, 5), (1024, 1),
                                  (77, 9), (300, 2)]):
        src = pclip(44100, 2, rng.standard_normal((ln, 2)) * 0.2)
        secs = [(off + i * (ln + 7)) / 44100.0 for i in range(ev)]
        off += ev * (ln + 7) + 50
        pairs.append((src, secs))
    # one event past the end: dropped in both paths (cpp:1146)
    pairs[1][1].append(29_999 / 44100.0 + 10.0)

    a = pclip(44100, 2, base)
    for src, secs in pairs:
        a.overlay_many(src, secs)
    b = pclip(44100, 2, base)
    b.overlay_groups(pairs)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# --------------------------------------------------------------------------
# port <-> JAX on the same clips
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gain_matches_jax(dtype):
    use_dtype(dtype)
    rng = np.random.default_rng(20)
    j, p = pair(44100, 2, rng.standard_normal((777, 2)))
    for g in (0.3, 1.7, -0.1):
        j.apply_volume_gain(g)
        p.apply_volume_gain(g)
    assert p.numpy().dtype == DTYPES[dtype][0]
    assert_same_bits(p, j)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("old,new", [
    ((44100, 2), (48000, 2)), ((48000, 2), (44100, 2)),
    ((44100, 2), (18000, 2)), ((8000, 2), (8000, 1)),
    ((1000, 1), (2000, 2)), ((44100, 3), (22050, 1)),
    ((22050, 2), (44100, 2)), ((24000, 1), (44100, 2)),
    ((48000, 3), (44100, 1)), ((44100, 5), (18000, 2))])
def test_resample_matches_jax(dtype, old, new):
    # XLA:CPU folds i / new_rate * old_rate into i * (old_rate * (1 /
    # new_rate)) and fuses the lerp's multiply and add (and, across
    # channel counts, the scaled difference of the channel sums); the port
    # computes the same, so the bits agree at rate ratios whose fractions
    # are not exact (the golden model above is the reference's order,
    # within 1e-12).  The port resamples in float64 whatever the clip's
    # dtype and casts back, so a float32 clip gets JAX's float64 bits of
    # the same samples, rounded to float32
    real = DTYPES[dtype][0]
    rng = np.random.default_rng(21)
    s = rng.standard_normal((997, old[1])).astype(real)
    use_dtype("float64")
    j = jclip(old[0], old[1], s)
    j.resample(*new)
    use_dtype(dtype)
    p = pclip(old[0], old[1], s)
    p.resample(*new)
    assert (p.num_frames, p.sample_rate, p.channels) == \
        (j.num_frames, j.sample_rate, j.channels)
    assert_same_bits(p, j.numpy().astype(real))


def test_resample_clamp_quirk_matches_jax():
    # a clip shorter than its channel count's clamp bound: every index
    # clamps to bound - 1 (negative: the last row, as both packages index)
    rng = np.random.default_rng(22)
    for frames, ch in ((3, 2), (2, 2), (5, 4)):
        j, p = pair(1000, ch, rng.standard_normal((frames, ch)))
        j.resample(3000, ch)
        p.resample(3000, ch)
        assert_same_bits(p, j)


@pytest.mark.parametrize("start,end", [
    (10, 40), (90, 120), (-15, 20), (150, 170), (-300, -250), (0, 0)])
def test_cut_clamps_like_jax(start, end):
    # lax.dynamic_slice clamps the start into [0, n] on the clip padded
    # with `length` zero rows: a start past the end gives zeros, a
    # negative start the clip's head
    rng = np.random.default_rng(23)
    j, p = pair(1000, 2, rng.standard_normal((100, 2)))
    j.cut(start, end)
    p.cut(start, end)
    assert p.num_frames == j.num_frames == end - start
    assert_same_bits(p, j)


def test_drop_mode_pins_jax():
    # zeros(6).at[[-1, -7, 2, 6]].add(1, mode="drop") == [0,0,1,0,0,1]:
    # a row in [-N, 0) wraps to the end, rows < -N or >= N drop
    want = np.asarray(jnp.zeros((6, 1)).at[jnp.array([-1, -7, 2, 6])].add(
        1.0, mode="drop"))
    assert want.ravel().tolist() == [0, 0, 1, 0, 0, 1]
    got = pops.overlay_many(torch.zeros((6, 1), dtype=torch.float64),
                            torch.ones((1, 1), dtype=torch.float64),
                            [-1, -7, 2, 6])
    assert_same_bits(got.numpy(), want)


@pytest.mark.parametrize("start", [-5, -40, -100, -101, -250, 95, 100, 130,
                                   0])
def test_overlay_out_of_range_matches_jax(start):
    # the overlay's rows follow mode="drop": a negative start adds its
    # rows in [-N, 0) at the end of the target (not the reference's
    # skip); a source longer than the target adds twice to the rows its
    # wrapped and unwrapped runs share, in source-row order
    rng = np.random.default_rng(24)
    t = rng.standard_normal((100, 2))
    for n in (30, 160, 260):
        s = rng.standard_normal((n, 2)) * 1e3
        j, p = pair(1000, 2, t)
        j.overlay(jclip(1000, 2, s), start)
        p.overlay(pclip(1000, 2, s), start)
        assert_same_bits(p, j)


def _order_sensitive(rng, shape):
    """Samples whose sums depend on their order in float64: large and
    small magnitudes mixed."""
    return rng.standard_normal(shape) * np.where(
        rng.random(shape) < 0.5, 1e16, 1.0)


def test_overlay_many_scatter_order_matches_jax():
    # overlapping events whose sums depend on their order: the port adds
    # them in JAX's (event) order; the reversed order gives other bits
    rng = np.random.default_rng(25)
    t = _order_sensitive(rng, (400, 2))
    s = _order_sensitive(rng, (120, 2))
    starts = np.array([0, 7, 7, 30, 65, 66, 200, -20, 390, -450, 300])
    secs = starts / 1000.0
    j, p = pair(1000, 2, t)
    j.overlay_many(jclip(1000, 2, s), secs)
    p.overlay_many(pclip(1000, 2, s), secs)
    assert_same_bits(p, j)
    rev = pclip(1000, 2, t)
    for st in starts[::-1]:
        rev.overlay(pclip(1000, 2, s), int(st))
    assert not np.array_equal(rev.numpy(), p.numpy())


@pytest.mark.parametrize("frames,route", [(65_536, "scatter"),
                                          (65_537, "fft")])
def test_overlay_many_route_threshold_matches_jax(frames, route,
                                                  monkeypatch):
    # 16 events x 65,536 source rows == 2**20 takes the scatter route,
    # one more row the FFT route; the port picks JAX's route by the
    # bucketed event count (13 events pad to 16)
    rng = np.random.default_rng(26)
    t = rng.standard_normal((150_000, 2)) * 0.1
    s = rng.standard_normal((frames, 2)) * 0.1
    secs = rng.integers(-1000, 140_000, 13) / 44100.0
    ffts = []
    real_rfft = torch.fft.rfft
    monkeypatch.setattr(torch.fft, "rfft",
                        lambda *a, **k: ffts.append(1) or real_rfft(*a, **k))
    j, p = pair(44100, 2, t)
    j.overlay_many(jclip(44100, 2, s), secs)
    p.overlay_many(pclip(44100, 2, s), secs)
    assert bool(ffts) == (route == "fft")
    if route == "scatter":
        assert_same_bits(p, j)
    else:
        np.testing.assert_allclose(p.numpy(), j.numpy(), rtol=0, atol=1e-9)


def test_overlay_many_fft_route_matches_jax():
    # negative starts wrap within the impulse train (so they cut the
    # clip's head, unlike the scatter route), starts at or past the end
    # vanish, duplicates sum
    rng = np.random.default_rng(27)
    N, n = 12_000, 20_000
    t = rng.standard_normal((N, 2)) * 0.1
    s = rng.standard_normal((n, 2)) * 0.1
    starts = rng.integers(0, N, 64)
    starts[:8] = [-500, -19_999, -40_000, N, N + 5, 3, 3, -70_000]
    out = pops.overlay_many(torch.tensor(t), torch.tensor(s), starts)
    want = jops.overlay_many(jnp.asarray(t), jnp.asarray(s),
                             jnp.asarray(starts, jnp.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-9)


def _groups(rng, make, rate=1000):
    """Groups whose cohorts sort in another order than they are given
    (event buckets 4, 1, 8, 2; length buckets 64, 128, 32) and whose
    onsets overlap, with order-sensitive samples."""
    spec = [(100, 3), (50, 1), (20, 7), (120, 2), (64, 4), (33, 1),
            (100, 4)]
    pairs = []
    for ln, ev in spec:
        src = _order_sensitive(rng, (ln, 2))
        secs = list(rng.integers(-30, 220, ev) / rate)
        pairs.append((src, secs))
    return [(make(rate, 2, src), secs) for src, secs in pairs]


def test_overlay_groups_cohort_order_matches_jax():
    rng = np.random.default_rng(28)
    t = _order_sensitive(rng, (240, 2))
    state = rng.bit_generator.state
    jpairs = _groups(rng, jclip)
    rng.bit_generator.state = state
    ppairs = _groups(rng, pclip)
    j, p = pair(1000, 2, t)
    j.overlay_groups(jpairs)
    p.overlay_groups(ppairs)
    assert_same_bits(p, j)
    # the order matters: the groups in the order given give other bits
    given = pclip(1000, 2, t)
    for src, secs in ppairs:
        given.overlay_many(src, secs)
    assert not np.array_equal(given.numpy(), p.numpy())


def test_overlay_groups_resamples_sources_like_jax():
    # a source in another format is resampled to the target's first
    rng = np.random.default_rng(29)
    t = rng.standard_normal((3000, 2)) * 0.1
    s = rng.standard_normal((400, 1)) * 0.1
    j, p = pair(2000, 2, t)
    j.overlay_groups([(jclip(1000, 1, s), [0.1, 0.7])])
    p.overlay_groups([(pclip(1000, 1, s), [0.1, 0.7])])
    assert_same_bits(p, j)


def test_stale_rate_cut_matches_jax():
    # cut in seconds reads the rate snapshot taken when the clip was made:
    # after resample and apply_speed it is stale (pybind:512-526); clone
    # and PtrCreatedAudioClip refresh it
    rng = np.random.default_rng(30)
    s = rng.standard_normal((2000, 2))
    j, p = pair(1000, 2, s)
    for c in (j, p):
        c.resample(2000, 2)
        c.apply_speed(1.5)
        c.cut(0.1, 0.6, time_unit="second")
    assert p._cached_rate == j._cached_rate == 1000
    assert p.sample_rate == j.sample_rate == 3000
    assert_same_bits(p, j)
    jw = R.PtrCreatedAudioClip(j)
    pw = P.PtrCreatedAudioClip(p)
    assert pw._cached_rate == jw._cached_rate == 3000
    jw.cut(0.01, 0.1, time_unit="second")
    pw.cut(0.01, 0.1, time_unit="second")
    assert_same_bits(pw, jw)
    assert p.clone()._cached_rate == j.clone()._cached_rate == 3000


def test_audio_clip_to_torch_carries_the_stale_rate():
    rng = np.random.default_rng(31)
    j = jclip(1000, 2, rng.standard_normal((500, 2)))
    j.resample(4000, 2)
    p = interop.audio_clip_to_torch(j.sample_rate, j.channels,
                                    np.asarray(j._buf), "cpu",
                                    cached_rate=j._cached_rate)
    assert (p.sample_rate, p.channels, p.num_frames, p._cached_rate) == \
        (4000, 2, j.num_frames, 1000)
    j.cut(0.05, 0.2, time_unit="second")
    p.cut(0.05, 0.2, time_unit="second")
    assert_same_bits(p, j)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_save_as_wav_bytes_match_jax(dtype):
    # samples past +-1 clamp, the rest truncate toward zero; the header
    # and every byte as JAX writes them
    use_dtype(dtype)
    rng = np.random.default_rng(32)
    s = rng.standard_normal((5000, 2)) * 0.7
    s[:4] = [[1.0, -1.0], [2.5, -3.0], [32766.5 / 32767, -0.0], [1e-9, 0]]
    j, p = pair(22050, 2, s)
    assert p.save_as_wav() == j.save_as_wav()
    jm, pm = pair(48000, 1, s[:, :1])
    assert pm.save_as_wav() == jm.save_as_wav()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_int16_casts_match_jax(dtype):
    use_dtype(dtype)
    rng = np.random.default_rng(33)
    s = (rng.standard_normal((3000, 2)) * 0.8).astype(DTYPES[dtype][0])
    got = pops.to_int16_device(torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jops.to_int16_device(jnp.asarray(s))))
    np.testing.assert_array_equal(pops.to_int16(s), jops.to_int16(s))
    np.testing.assert_array_equal(
        pops.to_f32_device(torch.tensor(s)).numpy(),
        np.asarray(jops.to_f32_device(jnp.asarray(s))))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_int16_created_matches_jax(dtype):
    use_dtype(dtype)
    data = np.random.default_rng(34).integers(-32768, 32768, 600,
                                              dtype=np.int16)
    j = R.Int16CreatedAudioClip(16000, 2, data)
    p = P.Int16CreatedAudioClip(16000, 2, data, device="cpu")
    assert p.num_frames == j.num_frames == 300
    assert_same_bits(p, j)


def test_chain_matches_jax():
    # a chain of every op, as a user would run it: gain, resample, the
    # overlays on both routes, overlay_groups, cut, WAV
    rng = np.random.default_rng(35)
    t = rng.standard_normal((30_000, 2)) * 0.05
    s1 = rng.standard_normal((700, 1)) * 0.2
    s2 = rng.standard_normal((40_000, 2)) * 0.1
    j, p = pair(24000, 2, t)
    for c, mk in ((j, jclip), (p, pclip)):
        c.apply_volume_gain(0.8)
        c.resample(44100, 2)
        c.overlay(mk(24000, 1, s1), -300, auto_resample=True)
        c.overlay_many(mk(44100, 2, s2[:500]), [0.01, 0.2, 0.2, 0.5])
        c.overlay_groups([(mk(44100, 2, s2[:90]), [0.3, 0.31]),
                          (mk(44100, 2, s2[:3000]), [0.0])])
        c.cut(100, 50_000)
    assert_same_bits(p, j)
    assert p.save_as_wav() == j.save_as_wav()
    # the FFT route on the chain's result: within JAX's tolerance
    secs = np.linspace(0.0, 0.9, 30)        # 32 x 40,000 rows > 2**20
    j.overlay_many(jclip(44100, 2, s2), secs)
    p.overlay_many(pclip(44100, 2, s2), secs)
    np.testing.assert_allclose(p.numpy(), j.numpy(), rtol=0, atol=1e-9)
