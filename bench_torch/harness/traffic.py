"""A traffic mix is a data file, ``bench_torch/traffic/<name>.json`` (one
object) or ``<name>.jsonl`` (the object on its first line, one frame's
data on each further line, under ``"lines"``).  Its ``"generator"`` names
the module ``bench_torch/generators/<generator>.py`` whose ``Generator(mix,
config, seed)`` turns it into each frame's input: ``frame(k)``, a pure
function of k and the seed.

Same seed, same frames: no generator reads the clock.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"


def load(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if path.exists():
        return json.loads(path.read_text())
    head, *lines = (TRAFFIC_DIR / f"{name}.jsonl").read_text().splitlines()
    mix = json.loads(head)
    mix["lines"] = [json.loads(line) for line in lines if line.strip()]
    return mix


def seed_rng(seed: int, salt: int) -> np.random.Generator:
    """A numpy generator from any whole ``seed`` (negative or above 64
    bits too) and a salt that keeps the uses of one seed apart."""
    return np.random.default_rng([seed % (1 << 64), salt])


def generator(mix: dict, config: dict, seed: int):
    module = importlib.import_module(
        f"bench_torch.generators.{mix['generator']}")
    return module.Generator(mix, config, seed)
