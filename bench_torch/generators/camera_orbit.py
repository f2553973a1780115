"""``camera_orbit``: the configuration's camera turned ``step_rad``
radians about y a frame, from an angle drawn from the seed; a frame's
input is its float32 model-view-projection matrix.  The rest of the mix
(``surface`` and the render options) is read by the mesh system."""

from __future__ import annotations

import math

import numpy as np

from ..harness.traffic import seed_rng


def perspective(fov_y: float, aspect: float, near: float, far: float):
    f = 1.0 / math.tan(fov_y / 2)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, center, up):
    eye = np.asarray(eye, np.float64)
    f = np.asarray(center, np.float64) - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -(m[:3, :3] @ eye)
    return m


def rotation_y(angle: float):
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


class Generator:
    def __init__(self, mix: dict, config: dict, seed: int):
        cam = config["camera"]
        self.base = (perspective(cam["fov_y"],
                                 config["width"] / config["height"],
                                 cam["near"], cam["far"])
                     @ look_at(cam["eye"], cam["center"], cam["up"]))
        self.angle0 = float(seed_rng(seed, 1).uniform(0.0, 2 * math.pi))
        self.step = float(mix["step_rad"])

    def frame(self, k: int) -> np.ndarray:
        return (self.base @ rotation_y(self.angle0 + k * self.step)).astype(
            np.float32)
