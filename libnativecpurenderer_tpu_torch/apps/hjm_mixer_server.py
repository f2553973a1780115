"""hjm_mixer web service.

Counterpart of ``libnativecpurenderer_tpu/apps/hjm_mixer_server.py``, a
behaviour mirror of the reference's ``src/hjm_mixer_server.py``: it
serves an upload page at ``GET /`` and takes ``POST
/🐱/<min>/<max>/<dnote>/<offset>`` with a MIDI body, answering with the
mix at 18 kHz, encoded as MP3 by the shared native media runtime, or
written as a WAV body (at the MP3 rate the 18 kHz snaps to) when that
runtime is not built, as the JAX service does.

As in the JAX package: stdlib ``http.server`` stands in for Flask, and the
reference's ``timidity | ffmpeg`` base track (:27) is synthesised here
(additive GM-family voices, ``synth_base``).  The voices are rendered on
the host with NumPy, as the JAX package renders them; the mix, the 18 kHz
resample and the float32 cast run on ``Handler.device`` (the card by
default).  :func:`main` loads the instrument banks once
(``hjm_mixer.Bank``, every file) and ``Handler`` hands that bank to each
request's mix, where upstream reloads the banks a request; the answer's
bytes are the same.

    python -m libnativecpurenderer_tpu_torch.apps.hjm_mixer_server \\
        --res <bank dir> [--port 8080] [--device cpu]
"""

from __future__ import annotations

import http.server
import os
import tempfile
import urllib.parse

import numpy as np

from .. import media
from ..audio import AudioClip
from ..models import midi
from ..ops import audio_ops
from . import hjm_mixer

INDEX_HTML = os.path.join(os.path.dirname(__file__), "hjm_mixer_index.html")


# GM program-family voices for the base synth (the timidity stand-in):
# program // 8 -> (harmonic amplitudes, attack s, decay s, sustain level,
# release s).  Sustain 0 is plucked or struck (exponential decay over the
# whole note); sustain > 0 holds its level until note-off.  The same
# table as the JAX package's, so both render the same voices.
_GM_FAMILIES = (
    ((1.0, .45, .28, .14, .07, .03), .004, 1.9, 0.0, .15),   # 0 piano
    ((1.0, .20, .55, .10, .30, .05), .002, 1.2, 0.0, .10),   # 1 chromatic
    ((1.0, .60, .45, .40, .25, .20), .010, .00, 1.0, .08),   # 2 organ
    ((1.0, .55, .30, .20, .10, .05), .003, 1.1, 0.0, .12),   # 3 guitar
    ((1.0, .70, .25, .10, .04, .02), .004, 1.4, 0.0, .10),   # 4 bass
    ((1.0, .35, .40, .25, .18, .12), .060, .25, .75, .25),   # 5 strings
    ((1.0, .30, .35, .22, .15, .10), .080, .25, .70, .30),   # 6 ensemble
    ((1.0, .65, .50, .40, .30, .22), .030, .20, .80, .12),   # 7 brass
    ((1.0, .50, .60, .30, .20, .12), .040, .20, .78, .15),   # 8 reed
    ((1.0, .15, .30, .08, .12, .04), .050, .15, .80, .18),   # 9 pipe
    ((1.0, .80, .60, .45, .30, .20), .010, .30, .70, .10),   # 10 synth lead
    ((1.0, .40, .30, .20, .12, .08), .120, .40, .65, .40),   # 11 synth pad
    ((1.0, .25, .45, .15, .25, .10), .050, .80, .30, .50),   # 12 synth fx
    ((1.0, .55, .35, .25, .15, .08), .008, 1.0, 0.0, .15),   # 13 ethnic
    ((1.0, .30, .20, .40, .10, .25), .002, .60, 0.0, .20),   # 14 percussive
    ((1.0, .20, .15, .10, .08, .05), .020, .50, .20, .30),   # 15 sfx
)


def collect_voiced_notes(mid: midi.MidiFile):
    """Like ``hjm_mixer.collect_notes`` but keeps the velocity, the
    channel's active GM program and the percussion flag (channel 10).
    Channels are global in SMF (format-1 files put program changes on a
    setup track), so the events of all tracks are merged in time order
    before voicing."""
    events = []
    for ti, track in enumerate(mid.tracks):
        for mi, msg in enumerate(track):
            if msg["type"] in ("program_change", "note_on", "note_off"):
                events.append((msg["sec_time"], ti, mi, msg))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    out = []
    program: dict = {}
    pending: dict = {}
    for _, _, _, msg in events:
        if msg["type"] == "program_change":
            program[msg["channel"]] = msg["program"]
            continue
        key = (msg["channel"], msg["note"])
        if msg["type"] == "note_on":
            if key in pending:
                st, vel = pending.pop(key)
                out.append((st, st + hjm_mixer.DEFAULT_NOTELENGTH,
                            key[1], vel, program.get(key[0], 0),
                            key[0] == 9))
            pending[key] = (msg["sec_time"], msg["velocity"])
        else:
            if key not in pending:
                continue
            st, vel = pending.pop(key)
            out.append((st, msg["sec_time"], key[1], vel,
                        program.get(key[0], 0), key[0] == 9))
    for key, (st, vel) in pending.items():
        out.append((st, st + hjm_mixer.DEFAULT_NOTELENGTH, key[1],
                    vel, program.get(key[0], 0), key[0] == 9))
    out.sort(key=lambda x: x[0])
    return out


def _render_tone(note: int, dur: float, vel: int, family: int,
                 drum: bool, rate: int) -> np.ndarray:
    """One voice on the host: an additive harmonic stack under an ADSR
    envelope, or a decaying low-passed noise burst for percussion."""
    amp = 0.16 * (vel / 127.0) ** 1.5
    if drum:
        n = int(rate * 0.22)
        rng = np.random.default_rng(note)        # deterministic per key
        x = rng.standard_normal(n)
        # a one-pole lowpass darkens low keys (toms, kicks) more than hats
        a = min(0.95, 0.35 + note / 127.0)
        y = np.empty_like(x)
        acc = 0.0
        b = 1.0 - a
        for i in range(n):
            acc = a * acc + b * x[i]
            y[i] = acc
        t = np.arange(n) / rate
        return (y * np.exp(-t * 28.0) * amp * 2.2)
    harm, atk, dec, sus, rel = _GM_FAMILIES[family]
    freq = 440.0 * 2 ** ((note - 69) / 12)
    dur = float(min(max(dur, 0.05), 6.0))
    n = int(rate * (dur + rel))
    t = np.arange(n) / rate
    wave = np.zeros(n)
    for k, h in enumerate(harm):
        f = freq * (k + 1)
        if f >= rate / 2:
            break
        wave += h * np.sin(2 * np.pi * f * t)
    wave /= sum(harm)
    env = np.ones(n)
    # every envelope stage is clamped to the rendered length: short notes
    # of slow families (strings, pads) can have atk + dec past dur + rel
    na = min(max(int(rate * atk), 1), n)
    env[:na] = np.linspace(0.0, 1.0, na, endpoint=False)
    if sus <= 0.0:
        if na < n:
            env[na:] = np.exp(-(t[na:] - t[na]) * (3.0 / dec))
    else:
        nd = min(na + int(rate * dec), n)
        if nd > na:
            env[na:nd] = 1.0 - (1.0 - sus) * (t[na:nd] - t[na]) / max(
                t[nd - 1] - t[na], 1e-9)
        env[nd:] = sus
    nr = int(rate * dur)
    if nr < n:
        env[nr:] *= np.exp(-(t[nr:] - t[nr]) * (4.0 / rel))
    return wave * env * amp


def synth_base(midi_bytes: bytes, rate: int = 44100, *,
               device="cuda") -> AudioClip:
    """The base track on ``device``: the notes voiced by ``_render_tone``,
    grouped by (family, note, velocity bucket, duration bucket, drum) so
    that each distinct waveform is one ``overlay_many``."""
    mid = midi.MidiFile(midi_bytes)
    notes = collect_voiced_notes(mid)
    if not notes:
        return AudioClip.slient(rate, 2, rate, device=device)
    max_time = max(et for _, et, *_ in notes) + 1.0
    base = AudioClip.slient(rate, 2, int(rate * max_time), device=device)
    groups: dict = {}
    for st, et, n, vel, prog, drum in notes:
        dur = et - st
        # geometric duration buckets share waveforms across near-equal
        # note lengths; velocity buckets of 8 steps likewise
        db = 0 if drum else max(0, int(np.ceil(np.log(max(dur, .05) / .05)
                                               / np.log(1.25))))
        key = (prog // 8, n, min(vel // 8, 15), db, drum)
        groups.setdefault(key, []).append(st)
    for (fam, n, vb, db, drum), secs in groups.items():
        wave = _render_tone(n, 0.05 * (1.25 ** db), vb * 8 + 4, fam,
                            drum, rate)
        tone = AudioClip._from_array(rate, 2, np.stack([wave, wave], axis=1),
                                     device=device)
        base.overlay_many(tone, secs)
    return base


def mix_request(midi_bytes: bytes, min_note: int, max_note: int,
                dnote: int, offset: int, res_dir: str, *,
                device="cuda", bank: hjm_mixer.Bank = None) -> bytes:
    """The request: base synth -> hjm mix -> 18 kHz -> encoded bytes (an
    MP3, or a WAV when the native media runtime is not built).  The mix
    takes its clips from ``bank``, or from a bank of ``res_dir`` made for
    this request."""
    base = synth_base(midi_bytes, device=device)
    if bank is None:
        bank = hjm_mixer.Bank(res_dir, base.sample_rate, base.channels,
                              base.device)
    wav = hjm_mixer.mix(midi_bytes, bank, min_note, max_note, dnote,
                        offset, base).save_as_wav()
    with tempfile.TemporaryDirectory() as td:
        wav_fp = os.path.join(td, "out.wav")
        with open(wav_fp, "wb") as f:
            f.write(wav)
        mixed = AudioClip.from_file(wav_fp, device=device)
        # the reference re-encodes at 18 kHz (:44-45)
        mixed.resample(18000, mixed.channels)
        mp3_fp = os.path.join(td, "out.mp3")
        media.encode_audio_file(
            mp3_fp, audio_ops.to_f32_device(mixed._buf).cpu().numpy(),
            18000, bit_rate=180000)
        with open(mp3_fp, "rb") as f:
            return f.read()


class Handler(http.server.BaseHTTPRequestHandler):
    res_dir = "../test_files/"
    device = "cuda"
    bank = None          # the resident bank; None: one a request

    def do_GET(self):
        if urllib.parse.unquote(self.path) in ("/", "/index.html"):
            with open(INDEX_HTML, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)

    def do_POST(self):
        parts = urllib.parse.unquote(self.path).strip("/").split("/")
        # route: /🐱/<min>/<max>/<dnote>/<offset>
        if len(parts) != 5 or parts[0] != "🐱":
            self.send_error(404)
            return
        try:
            min_note, max_note, dnote, offset = map(int, parts[1:])
            length = int(self.headers.get("Content-Length", "0"))
            midi_bytes = self.rfile.read(length)
            out = mix_request(midi_bytes, min_note, max_note, dnote,
                              offset, self.res_dir, device=self.device,
                              bank=self.bank)
        except Exception as e:  # 500 with the message (reference :38-41)
            body = str(e).encode()
            self.send_response(500)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", "audio/mpeg"
                         if media.native_available() else "audio/wav")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, fmt, *args):  # quiet
        pass


def main(host: str = "0.0.0.0", port: int = 8080, res_dir: str = None,
         device: str = "cuda"):
    if res_dir:
        Handler.res_dir = res_dir
    Handler.device = device
    Handler.bank = hjm_mixer.Bank(Handler.res_dir, device=device).preload()
    server = http.server.ThreadingHTTPServer((host, port), Handler)
    print(f"hjm_mixer server on {host}:{port}, mixing on {device}")
    server.serve_forever()


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--res", default="../test_files/")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    main(a.host, a.port, a.res, a.device)
