"""The port's benchmark: one run of one cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> \\
        --seconds <window> --trace <0|1>

Run from the root of a checkout.  The cells, configurations, traffic
mixes and metrics are those of ``BENCHMARK.json``; every file a cell needs
is found by name under ``bench_torch/`` (see ``harness/spec.py``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), and last ``checks``, each number compared beside its
limit; standard error ends with the same checks.  Without a CUDA device
it prints no result and exits with 2; where the process holds JAX,
jaxlib, flax or the JAX package once the run is over, it names them on
standard error, prints no result and exits with 3.
"""

import time

T_PROCESS = time.perf_counter_ns()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
