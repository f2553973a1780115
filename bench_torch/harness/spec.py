"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json`` or ``.jsonl``, whose ``"generator"`` is
``generators/<generator>.py``), its limits (``limits/<cell>.json``), its
system and the metric readers (``metrics/<metric>.py``) of the metrics
that list the cell or list no cells.

A system is the configuration's ``"system"``: ``systems/<system>.py``,
which brings the ``System`` a run drives (its ``batch``; ``submit`` each
frame's input, ``finish``, ``close``, ``reference`` and ``work``;
``record`` or None), its ``LIBRARY`` (the program's library whose
kernels a roofline reads, or None), the faults its check must catch
(``fault(kind)``, for ``faults.py``) and its cut for the CPU tests
(``small(cell, **variant)``, for ``tests/small.py``).  A frame is the
unit a system delivers to the sink: a u8 video frame, or one mixed clip
for a mixer.  A system may find more files by name, such as a
configuration's ``"scene"`` in ``scenes/<scene>.py``.

Adding a cell, a mix, a generator, a scene, a system or a metric adds
files and entries; nothing here changes."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

from . import traffic

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_benchmark(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def metric_reader(name: str):
    return importlib.import_module(f"bench_torch.metrics.{name}")


def system_module(name: str):
    return importlib.import_module(f"bench_torch.systems.{name}")


def system_part(name: str, part: str):
    """The function ``part`` of the system ``name``'s module; an error
    naming both where the module has none."""
    module = system_module(name)
    fn = getattr(module, part, None)
    if fn is None:
        raise NotImplementedError(
            f"{module.__name__} has no {part}(): a system file brings "
            f"System, LIBRARY, fault(kind) and small(cell, **variant)")
    return fn


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"({', '.join(cells)})")
        self.entry = cells[name]
        self.name = name
        confs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = confs[self.entry["config"]]
        self.config = json.loads((ROOT / self.config_entry["file"])
                                 .read_text())
        self.mix = traffic.load(self.entry["traffic"])
        lim = BENCH / "limits" / f"{name}.json"
        self.limits = json.loads(lim.read_text()) if lim.exists() else {}
        self.system = system_module(self.config["system"])
        self.chips = int(self.entry["chips"])

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
