"""The check that decides ``correct``, driven through a whole run on the
CPU at a small size (the look for a card skipped): sound runs pass it,
the control (the reference in the precision below the configuration's,
in the program's place) fails it through the same decision, and so does
the run with each fault of ``faults.py`` planted under the timed path,
and a run that loses a frame."""

import pytest
import torch

from bench_torch import faults
from bench_torch.harness import spec
from bench_torch.tests import small
from libnativecpurenderer_tpu_torch import pipeline

CELLS = small.CELLS
VARIANTS = [(n, False) for n in CELLS] + [("mesh10k_gouraud", True)]


def limit(c):
    return c.limits["worst_frame_off_share"]


@pytest.mark.parametrize("name,textured", VARIANTS)
def test_sound_run_is_correct_and_control_is_not(name, textured):
    c = small.cell(name, textured)
    out = small.run(c)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert list(out)[-1] == "checks"
    out = small.run(c, control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["worst_frame_off_share"]["value"] > limit(c)


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, kind):
    c = small.cell(name)
    with faults.planted(c.config["system"], kind):
        out = small.run(c)
    assert not out["correct"], out["checks"]
    assert out["checks"]["worst_frame_off_share"]["value"] > limit(c)


def test_missing_frame_is_not_correct(monkeypatch):
    c = small.cell("milthm_chart")
    real = pipeline.BatchedVideoPipeline._drain

    def drop_last(self):
        if self._inflight is not None and self._pending == []:
            self._inflight = None            # the last batch never arrives
        real(self)
    monkeypatch.setattr(pipeline.BatchedVideoPipeline, "_drain", drop_last)
    out = small.run(c)
    assert not out["correct"]
    assert out["checks"]["frames_missing"]["value"] > 0


def test_run_exits_without_a_card(tmp_path):
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = subprocess.run([sys.executable, str(spec.BENCH / "run.py"),
                        "--workload", "mesh10k_gouraud", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_traced_run_reports_per_layer_metrics():
    c = small.cell("milthm_chart")
    out = small.run(c, trace=True)
    assert out["correct"]
    names = {m["name"] for m in c.per_layer}
    assert {"record_ms_per_frame", "pipeline_host_ms_per_frame"} <= set(
        out["metrics"]) <= names
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
