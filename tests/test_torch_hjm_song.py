"""The port's MIDI mixer against the benchmark's plain reference
(``bench_torch/references/hjm_mix.py``: upstream's mixer over its
AudioClip engine in float64, from the generator's own notes) on the CPU,
at the benchmark cell's CPU cut: seeded songs of 64 notes from
``generators/midi_songs`` and seeded banks of 0.1 s tones from
``systems/hjm_mix``.  ``apps.hjm_mixer.mix`` on a resident ``Bank`` is
within one level of the reference on every sample in float32 and
float64; the reference in bfloat16, the cell's control, is not.  The
round-robin, the filter after ``dnote`` and the ``n + 12`` file quirk
agree with the reference's; a second mix on one bank decodes no file;
``main`` writes the bytes it wrote before the bank was split out, and
``mix_request`` answers the same with a resident bank as without; the
generator's onsets keep their margin from a whole frame."""

import json
import os
import types
from collections import defaultdict
from fractions import Fraction
from math import floor

import numpy as np
import pytest
import torch

from bench_torch.generators import midi_songs
from bench_torch.references import hjm_mix as ref
from bench_torch.systems import hjm_mix as system
from bench_torch.systems.audio_mix import wav_samples
from libnativecpurenderer_tpu_torch import AudioClip
from libnativecpurenderer_tpu_torch import config as pconfig
from libnativecpurenderer_tpu_torch.apps import hjm_mixer
from libnativecpurenderer_tpu_torch.apps import hjm_mixer_server as srv
from libnativecpurenderer_tpu_torch.models import midi
from libnativecpurenderer_tpu_torch.ops import audio_ops

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(__file__), "..", "bench_torch")
with open(os.path.join(BENCH, "configs", "hjm_mixer_song_1500.json")) as f:
    CONFIG = dict(json.load(f), bank_seconds=system.SMALL_BANK_S)
with open(os.path.join(BENCH, "traffic", "midi_songs_1500.json")) as f:
    FULL_MIX = json.load(f)
with open(os.path.join(BENCH, "limits", "hjm_song_1500.json")) as f:
    LIMIT = json.load(f)["worst_frame_off_share"]
MIX = dict(FULL_MIX, notes=system.SMALL_NOTES, gap_ticks=system.SMALL_GAPS,
           tempos=[[0, 500000], [21, 420000], [42, 560000]])
RATE, BANK_RATE = CONFIG["sample_rate"], CONFIG["bank_rate"]
REQUEST = (CONFIG["min_note"], CONFIG["max_note"], CONFIG["dnote"],
           CONFIG["offset"])


@pytest.fixture(autouse=True)
def port_default_dtype():
    prev = pconfig.default_dtype()
    yield
    pconfig.set_default_dtype(prev)


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    """The seeded banks: their int16 samples and the directory of their
    WAVs."""
    pcm = system.bank_pcm(CONFIG, 2 ** 31 + 21)
    root = str(tmp_path_factory.mktemp("hjm_bank"))
    system.write_bank(root, pcm, BANK_RATE)
    return pcm, root


def song(seed, mix=MIX):
    return midi_songs.song(mix, RATE, np.random.default_rng(seed))


def reference(pcm, s, request=REQUEST, dtype=torch.float64):
    clips = {}

    def clip_of(inst, f):
        if (inst, f) not in clips:
            clips[(inst, f)] = ref.resample(pcm[(inst, f)], BANK_RATE, RATE,
                                            dtype, "cpu")
        return clips[(inst, f)]

    evs, rows = ref.events(s["onsets_s"], s["notes"], *request, RATE)
    return ref.mix(evs, rows, 2, clip_of, dtype, "cpu").numpy()


def levels_off(got, want):
    assert got.shape == want.shape
    return np.abs(got.astype(np.int32) - want.astype(np.int32))


def off_share(got, want):
    return float((levels_off(got, want).max(-1) > 1).mean())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("seed", [5, 2 ** 40 + 3])
def test_mix_within_one_level_of_reference(bank, dtype, seed):
    pconfig.set_default_dtype(dtype)
    pcm, root = bank
    s = song(seed)
    b = hjm_mixer.Bank(root, RATE, 2, "cpu")
    got = wav_samples(hjm_mixer.mix(s["smf"], b, *REQUEST).save_as_wav())
    want = reference(pcm, s)
    assert levels_off(got, want).max() <= 1
    assert (want != 0).mean() > 0.5


def test_bfloat16_control_is_off_beyond_the_limit(bank):
    pcm, _ = bank
    s = song(6)
    share = off_share(reference(pcm, s, dtype=torch.bfloat16),
                      reference(pcm, s))
    assert share > 100 * LIMIT


@pytest.mark.parametrize("request_", [
    (36, 108, 0, 0), (60, 90, 0, 0), (40, 100, -12, 0), (30, 120, 7, 0)],
    ids=["all", "filtered", "down_octave", "up_7"])
def test_round_robin_filter_and_file_quirk_match_reference(request_):
    s = song(7)
    _, groups = hjm_mixer.note_groups(s["smf"], *request_)
    got = {(inst, n + 12): sorted(int(np.float64(sec) * RATE)
                                  for sec in secs)
           for (inst, n), secs in groups.items()}
    evs, _ = ref.events(s["onsets_s"], s["notes"], *request_, RATE)
    want = defaultdict(list)
    for inst, f, start in evs:
        want[(inst, f)].append(start)
    assert got == {k: sorted(v) for k, v in want.items()}
    lo, hi, dnote, _ = request_
    kept = [(n + dnote) for n in s["notes"] if lo <= n + dnote <= hi]
    assert sum(len(v) for v in got.values()) == len(kept)
    assert {f for _, f in got} == {n + 12 for n in kept}
    assert len(set(s["onsets_s"])) < len(s["onsets_s"])   # chords


def test_second_mix_on_one_bank_decodes_no_file(bank):
    pconfig.set_default_dtype(torch.float32)
    _, root = bank
    b = hjm_mixer.Bank(root, RATE, 2, "cpu")
    s = song(8)
    d0 = hjm_mixer.Bank.decodes
    first = hjm_mixer.mix(s["smf"], b, *REQUEST).save_as_wav()
    d1 = hjm_mixer.Bank.decodes
    _, groups = hjm_mixer.note_groups(s["smf"], *REQUEST)
    assert d1 - d0 == len(groups)            # one decode a clip played
    second = hjm_mixer.mix(s["smf"], b, *REQUEST).save_as_wav()
    assert hjm_mixer.Bank.decodes == d1 and second == first
    b.preload()                              # the rest of the 3 x 132
    assert hjm_mixer.Bank.decodes - d0 == 3 * 132
    b.preload()
    hjm_mixer.mix(song(9)["smf"], b, *REQUEST)
    assert hjm_mixer.Bank.decodes - d0 == 3 * 132


def main_before(args):
    """``hjm_mixer.main`` as it was before the bank was split out of it:
    a bank cache local to the call, each clip resampled by
    ``resample_like`` on the target's device."""
    with open(args.input, "rb") as f:
        mid = midi.MidiFile(f.read())
    notes = hjm_mixer.collect_notes(mid)
    max_time = notes[-1][0] + 1.0
    bgm = (AudioClip.slient(44100, 2, int(44100 * max_time),
                            device=args.device)
           if args.base is None else args.base)
    cache = {}

    def bank_clip(inst, n):
        if (inst, n) not in cache:
            clip = AudioClip.from_file(os.path.join(
                args.res, hjm_mixer.BANK_NAMES[inst], f"{n + 12}.wav"),
                device=bgm.device)
            clip.resample_like(bgm)
            cache[(inst, n)] = clip
        return cache[(inst, n)]

    groups = defaultdict(list)
    curri, lastsec = -1, -1e9
    for sec, _et, n in notes:
        n += args.dnote
        sec += args.offset / 1000
        if sec != lastsec:
            curri += 1
            lastsec = sec
        if n < args.min_note or n > args.max_note:
            continue
        curri = curri % 3
        groups[(curri, n)].append(sec)
    bgm.overlay_groups([(bank_clip(i, n), secs)
                        for (i, n), secs in groups.items()])
    with open(args.output, "wb") as f:
        f.write(bgm.save_as_wav())


def run_main(fn, tmp_path, root, s, name, base=None, **request):
    mid = tmp_path / "song.mid"
    mid.write_bytes(s["smf"])
    out = tmp_path / f"{name}.wav"
    kw = dict(min_note=REQUEST[0], max_note=REQUEST[1], dnote=0, offset=0)
    kw.update(request)
    fn(types.SimpleNamespace(res=root, input=str(mid), output=str(out),
                             base=base, device="cpu", **kw))
    return out.read_bytes()


@pytest.mark.parametrize("request_", [{}, {"offset": -250, "dnote": 5},
                                      {"offset": 40, "min_note": 60}],
                         ids=["plain", "before_zero", "late_filtered"])
def test_main_writes_the_bytes_it_wrote_before(bank, tmp_path, request_):
    # the tests' float64: the bank's float64 resample is the clip's own
    pconfig.set_default_dtype(torch.float64)
    _, root = bank
    s = song(10)
    now = run_main(hjm_mixer.main, tmp_path, root, s, "now", **request_)
    before = run_main(main_before, tmp_path, root, s, "before", **request_)
    assert now == before and len(now) > 44 + 4 * RATE


def test_main_onto_a_base_writes_the_bytes_it_wrote_before(bank, tmp_path):
    pconfig.set_default_dtype(torch.float64)
    _, root = bank
    s = song(11)

    def base():
        rng = np.random.default_rng(12)
        return AudioClip._from_array(RATE, 2, rng.standard_normal(
            (6 * RATE, 2)) * 0.05, device="cpu")

    now = run_main(hjm_mixer.main, tmp_path, root, s, "now", base())
    before = run_main(main_before, tmp_path, root, s, "before", base())
    assert now == before


def resample_in_buffer_dtype(buf, new_num, new_channels, new_rate,
                             old_rate):
    """``audio_ops.resample`` as it was before it widened to float64: the
    same folded, fused form in the buffer's dtype (same channel counts
    only)."""
    num_frames, channels = buf.shape
    assert channels == new_channels
    real = np.dtype(str(buf.dtype).replace("torch.", "")).type
    step = torch.tensor(real(old_rate) * (real(1) / real(new_rate)),
                        dtype=buf.dtype)
    idx = torch.arange(new_num, dtype=buf.dtype) * step
    lo = torch.clamp(torch.floor(idx), 0, num_frames - channels - 1)
    hi = torch.clamp(torch.ceil(idx), 0, num_frames - channels - 1)
    v_lo = buf[lo.long()]
    return torch.addcmul(v_lo, buf[hi.long()] - v_lo, (idx - lo)[:, None])


def test_float32_bank_resamples_in_float64(bank, tmp_path, monkeypatch):
    # in float32 the bank's resample (audio_ops.resample) runs in float64:
    # within a level of the reference, where the same resample in float32
    # arithmetic is not (its source index, ~4,800 at a 0.1 s clip's end,
    # is off by ~1e-3)
    pconfig.set_default_dtype(torch.float32)
    pcm, root = bank
    s = song(13)
    want = reference(pcm, s)
    now = wav_samples(run_main(hjm_mixer.main, tmp_path, root, s, "now"))
    assert levels_off(now, want).max() <= 1
    monkeypatch.setattr(audio_ops, "resample", resample_in_buffer_dtype)
    narrow = wav_samples(run_main(hjm_mixer.main, tmp_path, root, s,
                                  "narrow"))
    assert levels_off(narrow, want).max() > 1
    assert off_share(narrow, want) > LIMIT


def test_mix_request_with_a_resident_bank_answers_the_same(bank):
    pconfig.set_default_dtype(torch.float64)
    _, root = bank
    s = song(14, dict(MIX, notes=24))
    once = srv.mix_request(s["smf"], 40, 100, 0, -20, root, device="cpu")
    resident = hjm_mixer.Bank(root, RATE, 2, "cpu")
    first = srv.mix_request(s["smf"], 40, 100, 0, -20, root, device="cpu",
                            bank=resident)
    d = hjm_mixer.Bank.decodes
    again = srv.mix_request(s["smf"], 40, 100, 0, -20, root, device="cpu",
                            bank=resident)
    assert first == once == again and hjm_mixer.Bank.decodes == d


def test_mix_refuses_a_base_in_another_format(bank):
    _, root = bank
    b = hjm_mixer.Bank(root, RATE, 2, "cpu")
    base = AudioClip.slient(22050, 2, 22050, device="cpu")
    with pytest.raises(ValueError, match="format"):
        hjm_mixer.mix(song(15)["smf"], b, *REQUEST, base=base)


def test_generator_onsets_keep_their_margin_over_50_seeds():
    margin = midi_songs.MARGIN
    for seed in range(50):
        s = midi_songs.song(FULL_MIX, RATE, np.random.default_rng(
            [seed, 2 ** 40]))
        frames = [o * RATE for o in s["onsets_s"]]
        fracs = [f - floor(f) for f in frames]
        assert min(fracs) >= margin and max(fracs) <= 1 - margin
        assert len(s["notes"]) == FULL_MIX["notes"]
        assert all(a <= b for a, b in zip(s["ticks"], s["ticks"][1:]))
        # a float64 parse lands every onset on its exact start frame
        notes = hjm_mixer.collect_notes(midi.MidiFile(s["smf"]))
        got = sorted((int(np.float64(sec) * RATE), n) for sec, _, n in notes)
        want = sorted((floor(f), int(n)) for f, n in zip(frames, s["notes"]))
        assert got == want
    assert 100 < float(s["onsets_s"][-1]) < 130
    assert isinstance(s["onsets_s"][0], Fraction)
