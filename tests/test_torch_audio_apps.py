"""The port's MIDI -> WAV path on the CPU: ``models/midi``, ``media``, the
pydub interop, ``apps/hjm_mixer`` and its web service.

Mirrors of ``test_midi.py``, ``test_audio_interop.py`` and the hjm tests of
``test_apps.py`` against the port (``device="cpu"``), then the port
against the JAX package: the mixer's WAV bytes on seeded banks (negative
offsets included), the base synth within 1e-9 (its large groups take the
FFT route), the service's answer, and the host helpers of ``media``.
"""

import http.client
import http.server
import struct
import threading
import types
import wave

import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu import media as jmedia
from libnativecpurenderer_tpu.apps import hjm_mixer as jmixer
from libnativecpurenderer_tpu.apps import hjm_mixer_server as jsrv
from libnativecpurenderer_tpu_torch import audio as audio_mod
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch import media
from libnativecpurenderer_tpu_torch.apps import hjm_mixer
from libnativecpurenderer_tpu_torch.apps import hjm_mixer_server as srv
from libnativecpurenderer_tpu_torch.models import midi

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def port_f64_default():
    prev = pconfig.default_dtype()
    pconfig.set_default_dtype(torch.float64)
    yield
    pconfig.set_default_dtype(prev)


# --------------------------------------------------------------------------
# fixtures (as in test_apps.py and test_midi.py)
# --------------------------------------------------------------------------

def write_wav(path, pcm, rate=44100):
    """pcm: (N, C) float in [-1, 1]"""
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes())


def vlq(n):
    """variable-length quantity encoding"""
    out = [n & 0x7F]
    n >>= 7
    while n:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    return bytes(reversed(out))


def make_midi(events, division=480, tempo=500000):
    """events: list of (delta_ticks, status, data bytes)"""
    track = vlq(0) + bytes([0xFF, 0x51, 0x03]) + tempo.to_bytes(3, "big")
    for delta, status, data in events:
        track += vlq(delta) + bytes([status]) + bytes(data)
    track += vlq(0) + bytes([0xFF, 0x2F, 0x00])
    header = b"MThd" + struct.pack(">IHHH", 6, 0, 1, division)
    return header + b"MTrk" + struct.pack(">I", len(track)) + track


def make_midi_format1(tracks, division=480, tempo=500000):
    chunks = []
    for ti, events in enumerate(tracks):
        track = b""
        if ti == 0:
            track += (vlq(0) + bytes([0xFF, 0x51, 0x03])
                      + tempo.to_bytes(3, "big"))
        for delta, status, data in events:
            track += vlq(delta) + bytes([status]) + bytes(data)
        track += vlq(0) + bytes([0xFF, 0x2F, 0x00])
        chunks.append(b"MTrk" + struct.pack(">I", len(track)) + track)
    return (b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks), division)
            + b"".join(chunks))


def seeded_events(seed, n_notes, channels=3, lo=40, hi=100):
    """n_notes seeded notes on a few channels, some chords (onsets
    shared), program changes and a tempo change."""
    rng = np.random.default_rng(seed)
    ev = [(0, 0xC0 | c, [int(rng.integers(0, 128))]) for c in range(channels)]
    for k in range(n_notes):
        c = int(rng.integers(0, channels))
        note = int(rng.integers(lo, hi))
        gap = 0 if rng.random() < 0.3 else int(rng.integers(20, 240))
        ev.append((gap, 0x90 | c, [note, int(rng.integers(30, 127))]))
        ev.append((int(rng.integers(10, 400)), 0x80 | c, [note, 0]))
        if k == n_notes // 2:
            ev.append((0, 0xFF, [0x51, 0x03, 0x07, 0xA1, 0x20]))
    return ev


def riff_events(n=24, note=62):
    """One key, velocity and length (1 s) every 0.25 s on channels 10-13
    (program 0): one synth group of n onsets whose tone (~57k frames)
    takes the FFT route (32 x 57k rows > 2**20)."""
    ev = [(0, 0xC0 | c, [0]) for c in range(10, 14)]
    for k in range(n):
        c = 10 + k % 4
        ev.append((240 * k, 0x90 | c, [note, 100]))
        ev.append((240 * k + 960, 0x80 | c, [note, 0]))
    ev.sort(key=lambda e: e[0])          # stable: an off before an on
    out, tick = [], 0
    for t, status, data in ev:
        out.append((t - tick, status, data))
        tick = t
    return out


def seeded_song(seed, n_notes, channels=3, riff=False):
    """A seeded song: format 0, or format 1 with a riff track beside."""
    ev = seeded_events(seed, n_notes, channels)
    if not riff:
        return make_midi(ev)
    return make_midi_format1([ev, riff_events()])


@pytest.fixture
def mini_bank(tmp_path):
    """Tiny instrument bank: ha/ji/mi x notes 12..143, 64-frame clips with
    a per-(instrument, note) DC signature so overlays are verifiable."""
    for bi, name in enumerate(("ha", "ji", "mi")):
        d = tmp_path / name
        d.mkdir()
        for n in range(12, 144):
            val = (bi + 1) * 0.001 + n * 1e-5
            write_wav(str(d / f"{n}.wav"), np.full((64, 2), val), 44100)
    return str(tmp_path)


@pytest.fixture
def noise_bank(tmp_path):
    """A seeded bank as the reference's is laid out (48 kHz s16 stereo),
    300 frames of noise a file, so the mix resamples and its sums are
    order-sensitive."""
    rng = np.random.default_rng(3)
    root = tmp_path / "bank"
    for name in ("ha", "ji", "mi"):
        d = root / name
        d.mkdir(parents=True)
        for n in range(12, 144):
            write_wav(str(d / f"{n}.wav"),
                      rng.standard_normal((300, 2)) * 0.2, 48000)
    return str(root)


# --------------------------------------------------------------------------
# mirrors of tests/test_midi.py
# --------------------------------------------------------------------------

def test_basic_notes_and_seconds():
    # 480 ticks = 1 quarter = 0.5 s at 120 bpm
    data = make_midi([
        (0, 0x90, [60, 100]),       # note on C4 at t=0
        (480, 0x80, [60, 0]),       # off at 0.5 s
        (0, 0x91, [64, 90]),        # on ch1 E4 at 0.5 s
        (240, 0x81, [64, 0]),       # off at 0.75 s
    ])
    mid = midi.MidiFile(data)
    msgs = mid.tracks[0]
    assert [m["type"] for m in msgs] == ["note_on", "note_off",
                                         "note_on", "note_off"]
    assert msgs[0]["sec_time"] == 0.0
    assert abs(msgs[1]["sec_time"] - 0.5) < 1e-12
    assert msgs[2]["channel"] == 1
    assert abs(msgs[3]["sec_time"] - 0.75) < 1e-12


def test_running_status_and_vel0_noteoff():
    data = make_midi([
        (0, 0x90, [60, 100]),
        # running status: no status byte, note 62 on, then 60 off via vel 0
        (10, 62, [100]),
        (10, 60, [0]),
    ])
    mid = midi.MidiFile(data)
    msgs = mid.tracks[0]
    assert [(m["type"], m["note"]) for m in msgs] == [
        ("note_on", 60), ("note_on", 62), ("note_off", 60)]


def test_tempo_change():
    data = make_midi([
        (0, 0x90, [60, 100]),
        (480, 0xFF, [0x51, 0x03, 0x03, 0xD0, 0x90]),  # 250000 us/qn at beat 1
        (480, 0x80, [60, 0]),   # one more beat at new tempo: 0.5 + 0.25
    ])
    mid = midi.MidiFile(data)
    off = [m for m in mid.tracks[0] if m["type"] == "note_off"][0]
    assert abs(off["sec_time"] - 0.75) < 1e-9


def test_real_fixture(ref_files):
    with open(f"{ref_files}/rr.mid", "rb") as f:
        mid = midi.MidiFile(f.read())
    msgs = [m for t in mid.tracks for m in t]
    ons = [m for m in msgs if m["type"] == "note_on"]
    assert len(ons) > 100
    assert all(0 <= m["note"] < 128 for m in ons)
    assert all(m["sec_time"] >= 0 for m in msgs)
    for t in mid.tracks:
        secs = [m["sec_time"] for m in t]
        assert secs == sorted(secs)


def test_collect_notes_pairing():
    data = make_midi([
        (0, 0x90, [60, 100]),
        (0, 0x90, [64, 100]),
        (480, 0x80, [60, 0]),
        # 64 never gets an off -> default length 0.1
    ])
    notes = hjm_mixer.collect_notes(midi.MidiFile(data))
    notes.sort(key=lambda x: x[2])
    assert len(notes) == 2
    assert abs(notes[0][1] - 0.5) < 1e-12       # note 60: real off
    assert abs(notes[1][1] - 0.1) < 1e-12       # note 64: default length


def test_midi_parse_matches_jax():
    from libnativecpurenderer_tpu.models import midi as jmidi
    data = seeded_song(5, 300)
    assert midi.MidiFile(data).tracks == jmidi.MidiFile(data).tracks


# --------------------------------------------------------------------------
# mirrors of tests/test_audio_interop.py
# --------------------------------------------------------------------------

class StubSegment:
    """Duck-typed pydub.AudioSegment: 16-bit interleaved samples."""

    def __init__(self, samples_i16, frame_rate=22050, channels=2,
                 sample_width=2):
        self._s = np.asarray(samples_i16, np.int16)
        self.frame_rate = frame_rate
        self.channels = channels
        self.sample_width = sample_width

    def set_sample_width(self, w):
        assert w == 2
        return StubSegment(self._s, self.frame_rate, self.channels, 2)

    def get_array_of_samples(self, array_type_override=None):
        assert array_type_override == "h"
        return self._s.tolist()


def test_from_pydub_seg_int16_scaling():
    # the reference divides int16 by 32768 (cpp:1016-1034)
    samples = np.array([0, 16384, -32768, 32767, 100, -100], np.int16)
    clip = audio_mod.AudioClip.from_pydub_seg(
        StubSegment(samples, frame_rate=22050, channels=2), device="cpu")
    assert clip.sample_rate == 22050
    assert clip.channels == 2
    pcm = clip.numpy()
    assert pcm.shape == (3, 2)
    np.testing.assert_allclose(
        pcm, samples.astype(np.float64).reshape(3, 2) / 32768.0)


def test_from_pydub_seg_width_conversion():
    seg = StubSegment(np.array([1000, -1000], np.int16),
                      frame_rate=44100, channels=1, sample_width=4)
    clip = audio_mod.AudioClip.from_pydub_seg(seg, device="cpu")
    assert clip.num_frames == 2


def test_synth_base_golden():
    """The base synth against an independent NumPy rendering of the
    documented voice model (``_GM_FAMILIES`` / ``_render_tone``)."""
    # two piano notes: A4 (69) vel 100 at 0.0 s, C4 (60) vel 90 at 0.5 s
    data = make_midi([
        (0, 0x90, [69, 100]),
        (480, 0x80, [69, 0]),
        (0, 0x90, [60, 90]),
        (480, 0x80, [60, 0]),
    ])
    clip = srv.synth_base(data, device="cpu")
    rate = 44100
    assert clip.sample_rate == rate and clip.channels == 2

    harm = (1.0, .45, .28, .14, .07, .03)
    atk, dec, rel = .004, 1.9, .15
    max_time = 1.0 + 1.0
    n = int(rate * max_time)
    expected = np.zeros((n, 2))
    for note, sec, vel in ((69, 0.0, 100), (60, 0.5, 90)):
        vb = min(vel // 8, 15) * 8 + 4
        dur = 0.05 * 1.25 ** int(np.ceil(np.log(0.5 / 0.05)
                                         / np.log(1.25)))
        amp = 0.16 * (vb / 127.0) ** 1.5
        freq = 440.0 * 2 ** ((note - 69) / 12)
        ln = int(rate * (dur + rel))
        t = np.arange(ln) / rate
        wave_ = np.zeros(ln)
        for k, h in enumerate(harm):
            wave_ += h * np.sin(2 * np.pi * freq * (k + 1) * t)
        wave_ /= sum(harm)
        env = np.ones(ln)
        na = max(int(rate * atk), 1)
        env[:na] = np.linspace(0.0, 1.0, na, endpoint=False)
        env[na:] = np.exp(-(t[na:] - t[na]) * (3.0 / dec))
        nr = int(rate * dur)
        env[nr:] *= np.exp(-(t[nr:] - t[nr]) * (4.0 / rel))
        wave_ = wave_ * env * amp
        s_ = int(round(sec * rate))
        expected[s_:s_ + ln] += wave_[:, None]

    got = clip.numpy()
    assert got.shape[0] == n
    np.testing.assert_allclose(got, expected, atol=1e-6)
    assert np.abs(got).max() > 0.05


# --------------------------------------------------------------------------
# mirrors of the hjm tests of tests/test_apps.py
# --------------------------------------------------------------------------

def test_hjm_mixer_end_to_end(tmp_path, mini_bank):
    # two notes at distinct times + one filtered out
    data = make_midi([
        (0, 0x90, [60, 100]), (480, 0x80, [60, 0]),
        (0, 0x90, [64, 100]), (480, 0x80, [64, 0]),
        (0, 0x90, [10, 100]), (10, 0x80, [10, 0]),   # below min -> skipped
    ])
    mid_fp = tmp_path / "t.mid"
    mid_fp.write_bytes(data)
    out_fp = tmp_path / "out.wav"
    hjm_mixer.main(types.SimpleNamespace(
        res=mini_bank, input=str(mid_fp), output=str(out_fp),
        min_note=60, max_note=127, dnote=0, base=None, offset=0,
        device="cpu"))

    with wave.open(str(out_fp)) as w:
        assert w.getframerate() == 44100
        assert w.getnchannels() == 2
        pcm = np.frombuffer(w.readframes(w.getnframes()),
                            np.int16).reshape(-1, 2) / 32767.0
    # note 60 at t=0 round-robins to instrument 0 ("ha"), note 64 at t=0.5
    # to instrument 1 ("ji"); bank files are indexed by raw note (the
    # reference's off-by-12 quirk) so note 60 plays ha/72.wav's value
    v60 = 1 * 0.001 + 72 * 1e-5
    v64 = 2 * 0.001 + 76 * 1e-5
    assert abs(pcm[5, 0] - v60) < 2e-4
    at64 = int(0.5 * 44100) + 5
    assert abs(pcm[at64, 0] - v64) < 2e-4
    # silence between
    assert abs(pcm[int(0.3 * 44100), 0]) < 1e-4


def _serve(handler):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t


def test_hjm_server_request(tmp_path, mini_bank, monkeypatch):
    """Full HTTP round trip on a local port."""
    monkeypatch.setattr(srv.Handler, "res_dir", mini_bank)
    monkeypatch.setattr(srv.Handler, "device", "cpu")
    server, t = _serve(srv.Handler)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=120)
        conn.request("GET", "/")
        resp = conn.getresponse()
        assert resp.status == 200
        page = resp.read()
        assert b"midi" in page
        # the port's own page, not the JAX package's
        with open(jsrv.INDEX_HTML, "rb") as f:
            assert page != f.read()

        data = make_midi([(0, 0x90, [60, 100]), (480, 0x80, [60, 0])])
        conn.request("POST", "/%F0%9F%90%B1/60/127/0/0", body=data)
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 200, body
        if media.native_available():
            assert len(body) > 500
            fp = tmp_path / "resp.mp3"
            fp.write_bytes(body)
            rate, ch, pcm = media.decode_audio(str(fp))
            assert rate == 16000  # 18 kHz snapped to nearest lame rate
            assert pcm.shape[0] > 1000
        else:
            # the WAV written when the native runtime is absent, at the
            # MP3 rate 18 kHz snaps to, as the JAX service writes it
            assert resp.getheader("Content-Type") == "audio/wav"
            assert body[:4] == b"RIFF"
            assert struct.unpack("<i", body[24:28])[0] == 16000
        conn.request("POST", "/%F0%9F%90%B1/60/127/0", body=data)
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
    finally:
        server.shutdown()
        t.join(timeout=30)
        server.server_close()
    assert not t.is_alive()


def test_synth_base_gm_spectral_content():
    """The timidity stand-in renders instrument-like audio per note: the
    fundamental, harmonics, family envelopes (piano decays, organ
    sustains) and a broadband percussion channel."""
    data = make_midi([
        (0, 0xC0, [0]),              # ch0: piano (family 0, decaying)
        (0, 0xC1, [19]),             # ch1: organ (family 2, sustained)
        (0, 0x90, [69, 100]),        # A4 = 440 Hz
        (0, 0x91, [57, 96]),         # A3 = 220 Hz
        (480, 0x80, [69, 0]),        # off at 0.5 s
        (480, 0x81, [57, 0]),        # off at 1.0 s
        (0, 0x99, [38, 110]),        # ch10 snare at 1.0 s
        (48, 0x89, [38, 0]),
    ])
    clip = srv.synth_base(data, device="cpu")
    pcm = clip.numpy()[:, 0]
    rate = clip.sample_rate

    def spectrum(t0, t1):
        seg = pcm[int(t0 * rate):int(t1 * rate)]
        sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        freqs = np.fft.rfftfreq(len(seg), 1 / rate)
        return freqs, sp

    def peak_near(freqs, sp, f, tol=8.0):
        band = sp[(freqs > f - tol) & (freqs < f + tol)]
        return float(band.max()) if band.size else 0.0

    freqs, sp = spectrum(0.05, 0.45)
    p440 = peak_near(freqs, sp, 440.0)
    p880 = peak_near(freqs, sp, 880.0)
    assert p440 > 10.0 * np.median(sp)
    assert p880 > 0.1 * p440
    p220 = peak_near(freqs, sp, 220.0)
    p660 = peak_near(freqs, sp, 660.0)
    assert p220 > 10.0 * np.median(sp)
    assert p660 > 0.1 * p220

    def rms(t0, t1):
        seg = pcm[int(t0 * rate):int(t1 * rate)]
        return float(np.sqrt(np.mean(seg ** 2)))

    f2, sp2 = spectrum(0.75, 0.95)           # piano off-ish, organ on
    assert peak_near(f2, sp2, 220.0) > 0.4 * p220
    assert peak_near(f2, sp2, 440.0) < 0.6 * p440
    f3, sp3 = spectrum(1.0, 1.1)
    assert rms(1.0, 1.05) > 4.0 * rms(1.15, 1.2)
    assert sp3.max() < 100.0 * np.median(sp3[f3 > 100])


def test_render_tone_short_notes_all_families():
    """The shortest duration bucket (0.05 s) renders for every GM family:
    slow-attack/decay families must not index past the envelope."""
    for fam in range(len(srv._GM_FAMILIES)):
        w = srv._render_tone(60, 0.05, 100, fam, False, 44100)
        assert w.size > 0 and np.all(np.isfinite(w)), fam
        assert np.abs(w).max() > 0.0, fam
    w = srv._render_tone(38, 0.05, 100, 0, True, 44100)    # percussion
    assert np.all(np.isfinite(w))


def test_collect_voiced_notes_format1_program_changes():
    """Format-1 SMF: program changes on a setup track, notes on others —
    the channel's program carries across tracks."""
    data = make_midi_format1([
        [(0, 0xC0, [48]), (0, 0xC1, [19])],      # setup: strings, organ
        [(0, 0x90, [60, 100]), (480, 0x80, [60, 0])],   # ch0 notes
        [(0, 0x91, [64, 90]), (480, 0x81, [64, 0])],    # ch1 notes
    ])
    notes = srv.collect_voiced_notes(midi.MidiFile(data))
    progs = {n[2]: n[4] for n in notes}
    assert progs == {60: 48, 64: 19}


# --------------------------------------------------------------------------
# port <-> JAX
# --------------------------------------------------------------------------

@pytest.mark.parametrize("offset,dnote", [(0, 0), (-250, 0), (40, -12),
                                          (-3000, 5)])
def test_hjm_mixer_wav_bytes_match_jax(tmp_path, noise_bank, offset, dnote):
    # a seeded song through both mixers on the 48 kHz noise bank: the
    # bank's resample, the round-robin, the cohort order and the overlay
    # sums give the same WAV bytes; a negative offset starts notes before
    # zero, whose rows follow JAX's mode="drop"
    mid_fp = tmp_path / "song.mid"
    mid_fp.write_bytes(seeded_song(11, 120))
    outs = []
    for mod, extra in ((jmixer, {}), (hjm_mixer, {"device": "cpu"})):
        out_fp = tmp_path / f"{mod.__name__}.wav"
        mod.main(types.SimpleNamespace(
            res=noise_bank, input=str(mid_fp), output=str(out_fp),
            min_note=45, max_note=110, dnote=dnote, base=None,
            offset=offset, **extra))
        outs.append(out_fp.read_bytes())
    assert len(outs[0]) > 44 + 4 * 44100
    assert outs[1] == outs[0]


def test_hjm_mixer_cli_defaults_to_the_card():
    args = hjm_mixer.build_parser().parse_args(
        ["-r", "bank", "-i", "a.mid", "-o", "b.wav"])
    assert args.device == "cuda"
    assert (args.min_note, args.max_note, args.dnote, args.offset) == \
        (60, 127, 0, 0)
    assert hjm_mixer.build_parser().parse_args(
        ["-r", "b", "-i", "a", "-o", "c", "--device", "cpu",
         "--offset", "-40"]).offset == -40


def test_synth_base_matches_jax():
    # ~200 seeded notes (single-onset groups: the scatter route) and a
    # riff whose group takes the FFT route, held at JAX's 1e-9
    data = seeded_song(12, 200, channels=4, riff=True)
    got = srv.synth_base(data, device="cpu")
    want = jsrv.synth_base(data)
    assert got.num_frames == want.num_frames
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-9)
    drums = make_midi([(0, 0x99, [36, 100]), (30, 0x89, [36, 0]),
                       (0, 0x99, [42, 80]), (30, 0x89, [42, 0])])
    got = srv.synth_base(drums, device="cpu").numpy()
    np.testing.assert_array_equal(got, jsrv.synth_base(drums).numpy())


def test_mix_request_matches_jax(noise_bank):
    # the service's whole request: synth (FFT route within 1e-9) -> mix ->
    # WAV -> decode -> 18 kHz -> encode (a WAV at 16 kHz here): the int16
    # samples within one level of JAX's, and nearly all equal
    data = seeded_song(13, 80, channels=2, riff=True)
    got = srv.mix_request(data, 45, 110, 0, -20, noise_bank, device="cpu")
    want = jsrv.mix_request(data, 45, 110, 0, -20, noise_bank)
    assert len(got) == len(want) and got[:44] == want[:44]
    a = np.frombuffer(got[44:], "<i2").astype(np.int32)
    b = np.frombuffer(want[44:], "<i2").astype(np.int32)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() <= 1e-3


def test_media_host_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(14)
    tiles = rng.integers(0, 256, (8, 8 * 16, 4), np.uint8)    # 4x2 tiles
    np.testing.assert_array_equal(media.detile_u8(tiles, 30, 20, 8, 16),
                                  jmedia.detile_u8(tiles, 30, 20, 8, 16))
    fp = str(tmp_path / "a.wav")
    write_wav(fp, rng.standard_normal((500, 2)) * 0.4, 48000)
    got, want = media._decode_wav(fp), jmedia._decode_wav(fp)
    assert got[:2] == want[:2] == (48000, 2)
    np.testing.assert_array_equal(got[2], want[2])
    # the encoder's fallback: the MP3 rate snap on the host, then a WAV
    pcm = (rng.standard_normal((3000, 2)) * 0.5).astype(np.float32)
    if not media.native_available():
        for mod, name in ((media, "p.mp3"), (jmedia, "j.mp3")):
            mod.encode_audio_file(str(tmp_path / name), pcm, 18000)
        assert (tmp_path / "p.mp3").read_bytes() == \
            (tmp_path / "j.mp3").read_bytes()
