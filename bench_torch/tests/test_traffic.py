"""Each traffic mix is deterministic in its seed; seeds beyond 32 bits
and negative ones work; the camera orbit moves with the seed and the
recorded script replays the same frames for every seed."""

import numpy as np
import pytest

from bench_torch.generators import camera_orbit
from bench_torch.harness import spec, traffic

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def frames(cell, seed, n=3):
    g = traffic.generator(cell.mix, cell.config, seed)
    return [g.frame(k) for k in range(n)]


def same(a, b):
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 12345, 2 ** 70 + 3, -5])
def test_deterministic_in_seed(name, seed):
    c = spec.Cell(BENCH, name)
    a, b = frames(c, seed), frames(c, seed)
    assert all(same(x, y) for x, y in zip(a, b))
    # frames move from one to the next
    assert not same(a[0], a[1])


def test_camera_orbit_steps():
    c = spec.Cell(BENCH, "mesh10k_gouraud")
    g = traffic.generator(c.mix, c.config, 5)
    assert g.frame(0).dtype == np.float32 and g.frame(0).shape == (4, 4)
    assert np.allclose(g.frame(10), (g.base @ camera_orbit.rotation_y(
        g.angle0 + 0.3)).astype(np.float32))
    assert not same(g.frame(0), traffic.generator(c.mix, c.config,
                                                  6).frame(0))


def test_chart_script_replays_the_recorded_frames():
    c = spec.Cell(BENCH, "milthm_chart")
    lines = c.mix["lines"]
    assert len(lines) == 240 and c.mix["fps"] == 60
    a = traffic.generator(c.mix, c.config, 1)
    b = traffic.generator(c.mix, c.config, 2 ** 40)
    assert a.frame(7) == b.frame(7) == lines[7]
    assert a.frame(240 + 7) == lines[7]
    names = set(c.mix["textures"])
    calls = set()
    for f in lines:
        for name, *args in f:
            calls.add(name)
            assert all(a in names for a in args if isinstance(a, str))
    assert {"draw_texture", "draw_splitted_texture", "draw_line",
            "translate", "rotate_degree", "scale",
            "apply_color_transform"} <= calls
    assert c.mix["static_calls"][1][:2] == ["draw_texture", "bg"]
