"""The 10k-triangle scene of BASELINE config 3 ("10k-triangle rotating
mesh, per-pixel depth + Gouraud shading, 60-frame sequence at 1080p"),
as the benchmark builds it for the program and for the reference alike.

A copy of ``models/mesh.mesh_10k`` of the port (an icosphere of 5,120
faces, a smaller one of 1,280 above it and a ring of 1,800 quads, 10,000
faces in all, vertex colours from the position), so that the yardstick
does not move when the program's model module does.  Plus bench.py's
planar uvs of the textured variant.  Pure NumPy, float64; the harness
casts to the configuration's float32 once.
"""

from __future__ import annotations

import math

import numpy as np


def icosphere(subdiv: int):
    """Subdivided unit icosahedron: (verts (V, 3), faces (F, 3))."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        mids: dict = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = vlist[a] + vlist[b]
                mids[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return mids[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def build():
    """(verts (V, 3), faces (F, 3), colors (V, 4)): the 10,000 faces."""
    n_ring = 1800
    v, f = icosphere(4)
    v2, f2 = icosphere(3)
    v2 = v2 * 0.45 + np.array([0.0, 0.9, 0.0])
    ring_v, ring_f = [], []
    for i in range(n_ring):
        a = 2 * math.pi * i / n_ring
        r0, r1 = 1.35, 1.6
        ring_v += [[r0 * math.cos(a), 0.02 * math.sin(7 * a),
                    r0 * math.sin(a)],
                   [r1 * math.cos(a), -0.02 * math.sin(5 * a),
                    r1 * math.sin(a)]]
        j, k = 2 * i, 2 * ((i + 1) % n_ring)
        ring_f += [[j, j + 1, k], [j + 1, k + 1, k]]
    ring_v = np.asarray(ring_v)
    ring_f = np.asarray(ring_f, np.int64)
    verts = np.concatenate([v, v2, ring_v])
    faces = np.concatenate([f, f2 + len(v), ring_f + len(v) + len(v2)])
    colors = np.empty((len(verts), 4))
    colors[:, :3] = (verts + 1.6) / 3.2
    colors[:, 3] = 1.0
    return verts, faces, colors


def planar_uvs(verts):
    """bench.py:546-553's uvs: x and y scaled into [0, 1]."""
    xy = verts[:, :2]
    return (xy - xy.min(0)) / np.ptp(xy, 0)
