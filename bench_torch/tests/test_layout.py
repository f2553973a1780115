"""Every cell, configuration, mix, limit and metric of BENCHMARK.json is
found by name, and the file keeps to the benchmark's contract."""

import importlib
import json
import re

import pytest

from bench_torch.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    c = spec.Cell(BENCH, name)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(c.system, "System") and hasattr(c.system, "LIBRARY")
    assert callable(c.system.fault) and callable(c.system.small)
    assert c.chips == c.entry["chips"] in (1, 4)
    assert c.limits, f"no limits/{name}.json"
    assert c.end_to_end and c.per_layer
    assert {"setup_s", "frames_per_s"} <= {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.end_to_end}


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    reader = spec.metric_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    assert callable(reader.read)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
        assert any((spec.BENCH / "traffic" / f"{w['traffic']}{ext}").exists()
                   for ext in (".json", ".jsonl"))
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_torch/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {c["name"] for c in BENCH["configs"]} == {
        w["config"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_generator_and_scene_found_by_name(name):
    c = spec.Cell(BENCH, name)
    gen = importlib.import_module(
        f"bench_torch.generators.{c.mix['generator']}")
    assert callable(gen.Generator)
    if "scene" in c.config:
        scene = importlib.import_module(
            f"bench_torch.scenes.{c.config['scene']}")
        assert callable(scene.build)


def test_no_jax_imports():
    jax_package = "libnativecpurenderer" + "_tpu"
    for p in spec.BENCH.rglob("*.py"):
        text = p.read_text()
        assert not re.search(r"^\s*(import|from)\s+jax", text, re.M), p
        assert not re.search(jax_package + r"(?!_torch)", text), p
