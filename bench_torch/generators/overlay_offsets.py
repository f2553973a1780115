"""``overlay_offsets``: mix k's input is the offsets in seconds of the
mix's ``events`` overlays, drawn uniform over [``first_s``, ``last_s``]
from the seed and k and sorted (float64).  Every mix draws anew, so each
has its own events and each run its own mixes."""

from __future__ import annotations

import numpy as np

SALT = 5


class Generator:
    def __init__(self, mix: dict, config: dict, seed: int):
        self.seed = seed % (1 << 64)
        self.events = int(mix["events"])
        self.lo, self.hi = float(mix["first_s"]), float(mix["last_s"])

    def frame(self, k: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, SALT, k])
        return np.sort(rng.uniform(self.lo, self.hi, self.events))
