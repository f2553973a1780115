"""The quad batch of BASELINE config 2 ("textured quad batch with alpha
blending + z-test at 1280x720"), as the benchmark builds it for the
program and for the reference alike.

A copy of the recipe of the port's ``models.mesh.quad_batch`` (quads
parallel to xy, centres uniform in [-0.8, 0.8]^2, z in [0.2, 0.9],
half-size in [0.1, 0.35], uv the unit square; faces (a, b, c), (a, c, d)
a quad), drawn from the run's seed, so that the yardstick does not move
when the program's model module does.  Plus the stand-in sprite (RGB
uniform random, alpha a round falloff) and the opaque layer's depth
ramp, from fragment depths the reference yields.  NumPy, but for the
ramp's percentiles, which sort the depths on their device; the system
casts the vertices and uvs to the configuration's float32 once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..harness.traffic import seed_rng

QUAD_SALT = 11
SPRITE_SALT = 12


def build(n: int, seed: int):
    """(verts (4n, 3), faces (2n, 3) int64, uvs (4n, 2)), float64."""
    rng = seed_rng(seed, QUAD_SALT)
    c = rng.uniform(-0.8, 0.8, (n, 2))
    z = rng.uniform(0.2, 0.9, n)
    s = rng.uniform(0.1, 0.35, n)
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    verts = np.empty((n, 4, 3))
    verts[..., :2] = c[:, None, :] + s[:, None, None] * corners
    verts[..., 2] = z[:, None]
    b = 4 * np.arange(n)
    faces = np.stack([np.stack([b, b + 1, b + 2], 1),
                      np.stack([b, b + 2, b + 3], 1)], 1).reshape(-1, 3)
    uvs = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64),
                  (n, 1))
    return verts.reshape(-1, 3), faces, uvs


def sprite(size, seed: int):
    """(th, tw, 4) uint8: RGB uniform random; alpha
    round(255 (1 - r / r_corner)), r the distance of a texel's centre from
    the texture's centre and r_corner that of a corner texel's centre:
    about 255 at the centre, 0 at the corners."""
    th, tw = size
    rng = seed_rng(seed, SPRITE_SALT)
    tex = np.empty((th, tw, 4), np.uint8)
    tex[..., :3] = rng.integers(0, 256, (th, tw, 3), dtype=np.uint8)
    yy, xx = np.meshgrid(np.arange(th) + 0.5 - th / 2,
                         np.arange(tw) + 0.5 - tw / 2, indexing="ij")
    r = np.hypot(xx, yy)
    tex[..., 3] = np.round(255 * (1 - r / r.max())).astype(np.uint8)
    return tex


def opaque_ramp(depths, width: int, height: int):
    """The static opaque layer's depth, (H, W) float32: a ramp across the
    screen from the 25th percentile of ``depths`` (a tensor of fragment
    depths: the configuration's, those of the run's first frame) at x = 0
    to their 75th at x = W - 1 (linear between order statistics, as
    ``np.percentile``), so that the z test rejects a share of fragments
    that grows across the screen."""
    d = torch.sort(depths.reshape(-1)).values
    last = d.shape[0] - 1

    def percentile(q):
        i = q * last
        lo = math.floor(i)
        a, b = float(d[lo]), float(d[min(lo + 1, last)])
        return a + (b - a) * (i - lo)

    lo, hi = percentile(0.25), percentile(0.75)
    ramp = lo + (hi - lo) * np.arange(width) / (width - 1)
    return np.ascontiguousarray(np.broadcast_to(
        ramp.astype(np.float32), (height, width)))
