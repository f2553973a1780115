"""The readings a cell's limits are set from, on the card, in one process:
short runs at the cell's own load, one a seed.  The program's reading is
the worst sampled frame's off share of a sound run; the control's is the
same run's ``correct`` and share with the control (the reference computed
in the precision below the configuration's, ``systems/*.reference(
control=True)``) in the program's place; a fault's, with the fault
(``faults.py``) planted under the timed path.

    python3 bench_torch/control.py --workload <cell> --seeds 1,2,3 \\
        [--control 1,2,3] [--faults 1,2,3] [--seconds 3]

Prints one JSON line a run.  The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import faults  # noqa: E402
from bench_torch.harness import main, spec  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    runs = [("program", None, s) for s in seeds(args.seeds)]
    runs += [("control", None, s) for s in seeds(args.control)]
    runs += [(f"fault.{k}", k, s) for k in faults.KINDS
             for s in seeds(args.faults)]
    for what, kind, seed in runs:
        plant = (faults.planted(cell.config["system"], kind) if kind
                 else contextlib.nullcontext())
        t0 = time.perf_counter()
        with plant:
            out = main.run_cell(cell, seed, args.seconds, False, device,
                                time.perf_counter_ns(),
                                control=what == "control")
        print(json.dumps({
            "workload": args.workload, "run": what, "seed": seed,
            "correct": out["correct"],
            "checks": {k: c["value"] for k, c in out["checks"].items()},
            "frames": out["attempted"],
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(readings(sys.argv[1:]))
