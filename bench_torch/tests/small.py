"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
frame 160x96, batch 2, the raster's runs long enough for the whole mesh
at that size, and a chart script's calls drawn under a scale of 1/12 (a
static and every frame wrapped in ``save_state``, ``scale``,
``restore_state``), 12 frames from the middle of the chart.  Only the
CPU tests use them; the cells themselves run at their configurations'
sizes."""

from __future__ import annotations

import time

import torch

from bench_torch.harness import main, spec

W, H = 160, 96
SCALE = 1 / 12
FRAMES = 12


def wrap(calls):
    return [["save_state"], ["scale", SCALE, SCALE], *calls,
            ["restore_state"]]


BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def cell(name: str, textured: bool = False) -> spec.Cell:
    c = spec.Cell(BENCH, name)
    c.config = dict(c.config, width=W, height=H, batch=2)
    if c.config["system"] == "chart_video":
        # frames from the middle of the chart, where notes are on screen
        lines = c.mix["lines"]
        mid = len(lines) // 2
        c.mix = dict(c.mix, static_calls=wrap(c.mix["static_calls"]),
                     lines=[wrap(f) for f in lines[mid:mid + FRAMES]])
        c.mix["textures"] = {
            n: dict(t, height=min(t["height"], 96),
                    width=min(t["width"], 160))
            for n, t in c.mix["textures"].items()}
    else:
        c.config.update(capacity=4096, span_x=8, span_y=8)
        if textured:
            # the textured surface, with the limit its cell read on the
            # card (no cell of BENCHMARK.json runs it now)
            c.mix = dict(c.mix, surface="textured", texture=[16, 16],
                         render={"perspective_correct": True,
                                 "z_clip": True})
            c.limits = {"worst_frame_off_share": 4e-4}
    return c


def run(c: spec.Cell, seed: int = 2 ** 31 + 7, trace=False,
        control=False) -> dict:
    """A run on the CPU with a window long enough for two batches of the
    plain raster (a mesh frame takes 0.2-0.4 s there)."""
    seconds = 2.0 if c.config["system"] == "mesh_video" else 1.0
    return main.run_cell(c, seed, seconds, trace, torch.device("cpu"),
                         time.perf_counter_ns(), control=control)
