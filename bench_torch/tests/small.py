"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds.  The
cut is the system's own: its module's ``small(cell, **variant)`` gives
the configuration, mix and limits, and the seconds of the CPU window.
Only the CPU tests use them; the cells themselves run at their
configurations' sizes."""

from __future__ import annotations

import time

import torch

from bench_torch.harness import main, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def cell(name: str, textured: bool = False) -> spec.Cell:
    """The cell ``name`` cut by its system; ``textured`` asks the system
    for its textured variant."""
    c = spec.Cell(BENCH, name)
    variant = {"textured": True} if textured else {}
    cut = spec.system_part(c.config["system"], "small")
    c.config, c.mix, c.limits, c.cpu_seconds = cut(c, **variant)
    return c


def run(c: spec.Cell, seed: int = 2 ** 31 + 7, trace=False,
        control=False) -> dict:
    """A run on the CPU with the window its system's cut asks for."""
    return main.run_cell(c, seed, c.cpu_seconds, trace, torch.device("cpu"),
                         time.perf_counter_ns(), control=control)
