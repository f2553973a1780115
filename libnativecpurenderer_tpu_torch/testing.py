"""Seeded inputs shared by the port's CPU tests and ``chip_smoke.py``;
nothing on a render path imports this module."""

import math

import numpy as np
import torch


def crafted_uv_table(table):
    """The row table with the uv attribute columns of every valid row
    replaced by a seeded choice of: huge (x1e30), negative, a tiny or a
    zero denominator, NaN u and v; edges and z kept."""
    t = table.clone()
    ok = ~torch.isnan(t[:-1, 0])
    rows = torch.nonzero(ok).flatten()
    kind = torch.from_numpy(np.random.default_rng(9).integers(
        0, 5, rows.numel())).to(t.device)
    uv = torch.tensor([14 + 4 * i + d for i in range(3) for d in range(3)],
                      device=t.device)
    den = torch.tensor([16, 20, 24], device=t.device)
    for k, fn in enumerate((lambda x: x * 1e30, lambda x: -3.0 * x.abs())):
        r = rows[kind == k]
        t[r[:, None], uv] = fn(t[r[:, None], uv])
    t[rows[kind == 2][:, None], den] *= 1e-30
    t[rows[kind == 3][:, None], torch.tensor([14, 19],
                                             device=t.device)] = math.nan
    t[rows[kind == 4][:, None], den] = 0.0
    return t
