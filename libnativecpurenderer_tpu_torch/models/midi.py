"""Standard MIDI File (SMF) parser with tempo-map second-times.

The port's copy of ``libnativecpurenderer_tpu/models/midi.py`` (host
code; the port imports nothing of the JAX package).

The reference's hjm_mixer depends on an external ``midi_parse`` package
(the reference's ``src/hjm_mixer.py:5``) that supplies per-message
``sec_time``; that package isn't vendored in the reference repo, so this is
an independent SMF reader exposing the same consumed surface:

    MidiFile(data: bytes).tracks -> list[list[dict]]
    each message dict has at least: "type" ("note_on"/"note_off"),
    "channel", "note", "velocity", "sec_time".

Tick->second conversion uses a global tempo map collected from all tracks
(set-tempo meta 0x51; default 500000 us/qn; SMPTE divisions supported).
``note_on`` with velocity 0 is normalised to ``note_off`` (the standard
running-status convention; documented divergence — the reference's parser
behaviour is unknowable since it isn't in the repo).
"""

from __future__ import annotations

import bisect
from typing import List


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def u32(self) -> int:
        v = int.from_bytes(self.d[self.p:self.p + 4], "big")
        self.p += 4
        return v

    def u16(self) -> int:
        v = int.from_bytes(self.d[self.p:self.p + 2], "big")
        self.p += 2
        return v

    def u8(self) -> int:
        v = self.d[self.p]
        self.p += 1
        return v

    def take(self, n: int) -> bytes:
        v = self.d[self.p:self.p + n]
        self.p += n
        return v

    def varint(self) -> int:
        v = 0
        while True:
            b = self.u8()
            v = (v << 7) | (b & 0x7F)
            if not (b & 0x80):
                return v

    @property
    def eof(self) -> bool:
        return self.p >= len(self.d)


class TempoMap:
    """Piecewise tick->second conversion."""

    def __init__(self, division: int, tempos: List[tuple]):
        # tempos: sorted [(tick, us_per_qn)]; implicit (0, 500000) start
        self.division = division
        if not tempos or tempos[0][0] != 0:
            tempos = [(0, 500000)] + tempos
        self.ticks = [t for t, _ in tempos]
        self.secs = []
        acc = 0.0
        for i, (tick, uspq) in enumerate(tempos):
            self.secs.append(acc)
            nxt = tempos[i + 1][0] if i + 1 < len(tempos) else None
            if nxt is not None:
                acc += (nxt - tick) * uspq / 1e6 / division
        self.uspq = [u for _, u in tempos]

    def to_sec(self, tick: int) -> float:
        i = bisect.bisect_right(self.ticks, tick) - 1
        return (self.secs[i]
                + (tick - self.ticks[i]) * self.uspq[i] / 1e6 / self.division)


class MidiFile:
    def __init__(self, data: bytes):
        r = _Reader(data)
        if r.take(4) != b"MThd":
            raise ValueError("not a MIDI file")
        hlen = r.u32()
        self.format = r.u16()
        ntrks = r.u16()
        division = r.u16()
        r.take(hlen - 6)
        if division & 0x8000:
            # SMPTE: upper byte = negative fps, lower = ticks/frame
            fps = 256 - (division >> 8)
            tpf = division & 0xFF
            self._smpte_tps = fps * tpf
            self.division = None
        else:
            self._smpte_tps = None
            self.division = division

        raw_tracks = []
        for _ in range(ntrks):
            if r.eof:
                break
            while r.take(4) != b"MTrk":
                # skip unknown chunk
                skip = r.u32()
                r.take(skip)
                if r.eof:
                    raise ValueError("truncated MIDI file")
            tlen = r.u32()
            raw_tracks.append(self._parse_track(_Reader(r.take(tlen))))

        if self._smpte_tps is None:
            tempos = sorted(
                (tick, uspq)
                for trk in raw_tracks
                for tick, uspq in trk["tempos"])
            tmap = TempoMap(self.division, tempos)
            to_sec = tmap.to_sec
        else:
            tps = self._smpte_tps
            to_sec = lambda tick: tick / tps  # noqa: E731

        self.tracks: List[List[dict]] = []
        for trk in raw_tracks:
            msgs = []
            for m in trk["events"]:
                m["sec_time"] = to_sec(m["tick"])
                msgs.append(m)
            self.tracks.append(msgs)

    @staticmethod
    def _parse_track(r: _Reader) -> dict:
        tick = 0
        status = 0
        events = []
        tempos = []
        while not r.eof:
            tick += r.varint()
            b = r.u8()
            if b == 0xFF:                       # meta
                mtype = r.u8()
                mlen = r.varint()
                mdata = r.take(mlen)
                if mtype == 0x51 and mlen == 3:
                    tempos.append((tick, int.from_bytes(mdata, "big")))
                if mtype == 0x2F:
                    break
                continue
            if b in (0xF0, 0xF7):               # sysex
                slen = r.varint()
                r.take(slen)
                continue
            if b & 0x80:
                status = b
                d0 = r.u8()
            else:                               # running status
                d0 = b
            kind = status & 0xF0
            channel = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                d1 = r.u8()
            else:
                d1 = 0
            if kind == 0x90 and d1 > 0:
                events.append({"type": "note_on", "channel": channel,
                               "note": d0, "velocity": d1, "tick": tick})
            elif kind == 0x80 or (kind == 0x90 and d1 == 0):
                events.append({"type": "note_off", "channel": channel,
                               "note": d0, "velocity": d1, "tick": tick})
            elif kind == 0xC0:
                # instrument selection — drives the GM-ish base synth
                # (apps/hjm_mixer_server.synth_base)
                events.append({"type": "program_change",
                               "channel": channel, "program": d0,
                               "tick": tick})
        return {"events": events, "tempos": tempos}
