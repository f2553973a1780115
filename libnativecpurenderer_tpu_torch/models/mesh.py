"""Mesh generation + camera math for the 3D raster pipeline.

Scene models for the BASELINE workloads (single triangle, textured quad
batch, 10k-triangle rotating mesh).  Pure NumPy on the host — meshes are
built once and shipped to device.
"""

from __future__ import annotations

import math

import numpy as np


def perspective(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    f = 1.0 / math.tan(fov_y / 2)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, np.float64)
    f = np.asarray(center, np.float64) - eye
    f /= np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4)
    m[0, 0] = c
    m[0, 2] = s
    m[2, 0] = -s
    m[2, 2] = c
    return m


def rotation_x(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4)
    m[1, 1] = c
    m[1, 2] = -s
    m[2, 1] = s
    m[2, 2] = c
    return m


def icosphere(subdiv: int = 4):
    """Subdivided icosahedron: (verts (V,3), faces (F,3)).  subdiv=4 gives
    5120 faces; 5 gives 20480."""
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
        edge_mid = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab = midpoint(a, b)
            bc = midpoint(b, c)
            ca = midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def mesh_10k():
    """~10k-triangle sphere mesh with positional vertex colors — the
    BASELINE config-3 scene."""
    v, f = icosphere(4)          # 5120 faces
    v2, f2 = icosphere(3)        # 1280 faces
    # second smaller sphere offset, plus a ring of quads -> ~10k faces
    v2 = v2 * 0.45 + np.array([0.0, 0.9, 0.0])
    ring_v = []
    ring_f = []
    n_ring = 1800
    base = 0
    for i in range(n_ring):
        a = 2 * math.pi * i / n_ring
        a2 = 2 * math.pi * (i + 1) / n_ring
        r0, r1 = 1.35, 1.6
        ring_v += [[r0 * math.cos(a), 0.02 * math.sin(7 * a), r0 * math.sin(a)],
                   [r1 * math.cos(a), -0.02 * math.sin(5 * a), r1 * math.sin(a)]]
        j = base + 2 * i
        k = base + 2 * ((i + 1) % n_ring)
        ring_f += [[j, j + 1, k], [j + 1, k + 1, k]]
    ring_v = np.asarray(ring_v)
    ring_f = np.asarray(ring_f, np.int64)

    verts = np.concatenate([v, v2, ring_v + 0.0])
    faces = np.concatenate([f, f2 + len(v), ring_f + len(v) + len(v2)])
    colors = np.empty((len(verts), 4))
    colors[:, 0] = (verts[:, 0] + 1.6) / 3.2
    colors[:, 1] = (verts[:, 1] + 1.6) / 3.2
    colors[:, 2] = (verts[:, 2] + 1.6) / 3.2
    colors[:, 3] = 1.0
    return verts, faces, colors


def quad_batch(n: int, seed: int = 0):
    """n textured quads (2n triangles) at random depths/positions in NDC-ish
    object space — the BASELINE config-2 scene."""
    rng = np.random.default_rng(seed)
    verts = []
    faces = []
    uvs = []
    for i in range(n):
        cx, cy = rng.uniform(-0.8, 0.8, 2)
        z = rng.uniform(0.2, 0.9)
        s = rng.uniform(0.1, 0.35)
        b = len(verts)
        verts += [[cx - s, cy - s, z], [cx + s, cy - s, z],
                  [cx + s, cy + s, z], [cx - s, cy + s, z]]
        uvs += [[0, 0], [1, 0], [1, 1], [0, 1]]
        faces += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    return (np.asarray(verts), np.asarray(faces, np.int64),
            np.asarray(uvs))
