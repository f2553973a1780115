"""A system of a third kind, added as a later cell would add one: its
system module and generator installed under their names, its
configuration, mix and limits in files of their own, its workload entry
beside the benchmark's.  No file of the harness names a system, so the
whole run (the check that decides ``correct``, its control, the faults
planted through ``faults.planted``, the CPU cut through ``small.cell``
and the system-agnostic metrics) takes it as it is.

The stub mixes: each frame is a seeded int16 (N, 2) clip, a short seeded
sound overlaid at seeded offsets into a seeded buffer, in float32; its
reference mixes in float64, its control in bfloat16."""

import copy
import json
import sys
import types
from pathlib import Path
from types import SimpleNamespace as NS
from unittest import mock

import numpy as np
import pytest
import torch

from bench_torch import faults
from bench_torch.harness import main, spec, traffic
from bench_torch.harness.trace import WINDOW, Trace
from bench_torch.tests import small

STUB = "stub_mixdown"
GEN = "stub_overlays"
CONFIG = {"name": "stub_clip", "system": STUB, "samples": 441000,
          "sound_samples": 256, "batch": 2,
          "precision": "float32, int16 out"}
MIX = {"generator": GEN, "events": 6}
LIMITS = {"worst_frame_off_share": 0.0}
CELL = {"name": "stub_clip.overlays", "config": "stub_clip",
        "traffic": "stub_overlays", "chips": 1,
        "why": "a stub mixer: seeded overlays into a seeded clip"}
AGNOSTIC = {"launches_per_frame", "device_idle",
            "pipeline_host_ms_per_frame"}


def overlay(base, sound, offsets):
    """``sound`` added into a copy of ``base`` at each offset, in their
    dtype, quantised to int16."""
    out = base.clone()
    for o in offsets:
        out[o:o + sound.shape[0]] += sound
    return torch.round(out.clamp(-1, 1) * 32767).to(torch.int16)


class Mixer:
    """The stub's program: a batch of frames mixed in float32."""

    @staticmethod
    def mix(base, sound, batch):
        return torch.stack([overlay(base, sound, o) for o in batch])


class StubSystem:
    record = None

    def __init__(self, config, mix, seed, device, sink):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(traffic.seed_rng(seed, 3).integers(1 << 62)))
        n, s = config["samples"], config["sound_samples"]
        raw = torch.rand(2 * (n + s), generator=gen, device=device,
                         dtype=torch.float64) - 0.5
        self.base = raw[:2 * n].view(n, 2) * 0.5
        self.sound = raw[2 * n:].view(s, 2) * 0.25
        self.sink, self.batch, self.pending = sink, config["batch"], []

    def submit(self, offsets):
        self.pending.append(offsets)
        if len(self.pending) == self.batch:
            self._deliver()

    def finish(self):
        if self.pending:
            self._deliver()

    def _deliver(self):
        clips = Mixer.mix(self.base.float(), self.sound.float(),
                          self.pending)
        self.pending = []
        for clip in clips.cpu().numpy():
            self.sink.put_frame_u8(clip)

    def close(self):
        self.pending = None

    def reference(self, offsets, device, control=False):
        dtype = torch.bfloat16 if control else torch.float64
        return overlay(self.base.to(device, dtype),
                       self.sound.to(device, dtype), offsets)

    def work(self, inputs, device):
        return {}


class Overlays:
    """Frame k's input: the offsets of the mix's ``events`` overlays,
    drawn from the seed and k."""

    def __init__(self, mix, config, seed):
        self.seed, self.events = seed, mix["events"]
        self.last = config["samples"] - config["sound_samples"]

    def frame(self, k):
        rng = np.random.default_rng([self.seed % (1 << 64), 5, k])
        return [int(o) for o in rng.integers(0, self.last, self.events)]


def stub_fault(kind):
    real = Mixer.mix

    def planted(base, sound, batch):
        clips = real(base, sound, batch)
        if kind == "unchanged":
            clips[:] = overlay(base, sound, [])
        elif kind == "half":
            clips[clips.shape[0] // 2:] = 0
        else:
            clips[:, 8:40] ^= 0x55
        return clips
    return mock.patch.object(Mixer, "mix", staticmethod(planted))


def stub_small(cell):
    return dict(cell.config, samples=4096), cell.mix, cell.limits, 0.5


def module(name, **parts):
    m = types.ModuleType(name)
    m.__dict__.update(parts)
    return m


@pytest.fixture
def stub(monkeypatch, tmp_path):
    """The stub's cell, found by name: its modules in ``sys.modules``,
    its files in ``tmp_path``, its entries in the benchmark that
    ``small`` reads."""
    monkeypatch.setitem(sys.modules, f"bench_torch.systems.{STUB}", module(
        f"bench_torch.systems.{STUB}", System=StubSystem, LIBRARY=None,
        fault=stub_fault, small=stub_small))
    monkeypatch.setitem(sys.modules, f"bench_torch.generators.{GEN}",
                        module(f"bench_torch.generators.{GEN}",
                               Generator=Overlays))
    (tmp_path / "limits").mkdir()
    (tmp_path / "limits" / f"{CELL['name']}.json").write_text(
        json.dumps(LIMITS))
    (tmp_path / f"{CELL['traffic']}.json").write_text(json.dumps(MIX))
    (tmp_path / "stub_clip.json").write_text(json.dumps(CONFIG))
    monkeypatch.setattr(spec, "BENCH", tmp_path)
    monkeypatch.setattr(traffic, "TRAFFIC_DIR", tmp_path)
    bench = copy.deepcopy(small.BENCH)
    bench["configs"].append({"name": CONFIG["name"], "source": "a test",
                             "file": str(tmp_path / "stub_clip.json"),
                             "reduced": [], "why": "a stub mixer"})
    bench["workloads"].append(CELL)
    monkeypatch.setattr(small, "BENCH", bench)
    return small.cell(CELL["name"])


def test_stub_cell_found_by_name(stub):
    assert stub.config["samples"] == 4096 and stub.cpu_seconds == 0.5
    assert stub.limits == LIMITS and stub.mix["events"] == 6
    assert {m["name"] for m in stub.end_to_end} == {"frames_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in stub.per_layer} == AGNOSTIC


def test_sound_run_is_correct_and_control_is_not(stub):
    out = small.run(stub)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(out)[-1] == "checks"
    out = small.run(stub, control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["worst_frame_off_share"]["value"] > 0


@pytest.mark.parametrize("kind", faults.KINDS)
def test_fault_is_not_correct(stub, kind):
    with faults.planted(STUB, kind):
        out = small.run(stub)
    assert not out["correct"], out["checks"]
    assert out["checks"]["worst_frame_off_share"]["value"] > 0
    out = small.run(stub)                   # restored
    assert out["correct"], out["checks"]


def test_lost_frame_is_not_correct(stub, monkeypatch):
    real = StubSystem._deliver

    def lossy(self):
        self.pending = self.pending[:-1]   # a batch's last frame is lost
        real(self)
    monkeypatch.setattr(StubSystem, "_deliver", lossy)
    out = small.run(stub)
    assert not out["correct"]
    assert out["checks"]["frames_missing"]["value"] > 0


def test_traced_run_reports_the_system_agnostic_metrics(stub, monkeypatch):
    """The CPU runs no device operation, so the profiled window gets one
    device interval over its first half, as a card's trace would hold."""
    def with_device(events, frames):
        win = next(e for e in events if e.name == WINDOW
                   and e.device_type.name != "CUDA")
        lo, hi = win.time_range.start, win.time_range.end
        op = NS(name="stub_mix_kernel", device_type=NS(name="CUDA"),
                time_range=NS(start=lo, end=(lo + hi) / 2))
        return Trace(list(events) + [op], frames)
    monkeypatch.setattr(main, "Trace", with_device)
    out = small.run(stub, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == AGNOSTIC
    assert out["metrics"]["device_idle"]["value"] == pytest.approx(50.0)
    assert out["metrics"]["launches_per_frame"]["value"] == 0
    assert out["metrics"]["pipeline_host_ms_per_frame"]["value"] > 0


def test_shared_files_name_no_system():
    systems = [p.stem for p in (spec.BENCH / "systems").glob("*.py")
               if p.stem != "__init__"]
    assert {"mesh_video", "chart_video"} <= set(systems)
    shared = [spec.BENCH / "faults.py", spec.BENCH / "tests" / "small.py",
              *(spec.BENCH / "harness").glob("*.py")]
    for path in shared:
        text = Path(path).read_text()
        for name in systems:
            assert name not in text, (path, name)


@pytest.mark.parametrize("part", ["fault", "small"])
def test_system_without_a_part_is_named(stub, monkeypatch, part):
    name = f"bench_torch.systems.{STUB}"
    monkeypatch.delattr(sys.modules[name], part)
    with pytest.raises(NotImplementedError, match=rf"{name} has no {part}"):
        if part == "fault":
            faults.planted(STUB, "half")
        else:
            small.cell(CELL["name"])


@pytest.mark.parametrize("name,loaded", [
    ("jax", True), ("jaxlib.xla_extension", True), ("flax.linen", True),
    ("libnativecpurenderer" + "_tpu.ops", True),
    ("libnativecpurenderer" + "_tpu_torch.stub", False)])
def test_run_that_loads_jax_prints_no_result(stub, monkeypatch, capsys,
                                             name, loaded):
    """A module loaded under the stub's timed path: one of the JAX stack
    or of the JAX package leaves the run without a result; one of the
    port, whose name begins with the JAX package's, does not."""
    real = StubSystem.submit

    def loading(self, offsets):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        real(self, offsets)
    monkeypatch.setattr(StubSystem, "submit", loading)
    rc = main.report(small.run(stub))
    out, err = capsys.readouterr()
    if loaded:
        assert rc != 0 and out == ""
        assert f"the run loaded {name.split('.')[0]}: no result" in err
    else:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"]


def test_off_share_of_an_int16_clip():
    n = 1000
    want = torch.from_numpy(np.random.default_rng(1).integers(
        -20000, 20000, (n, 2)).astype(np.int16))
    assert main.off_share(want.numpy() + np.int16(1), want) == 0.0
    got = want.numpy().copy()
    got[n // 2, 1] += 2
    assert main.off_share(got, want) == pytest.approx(1 / n)
