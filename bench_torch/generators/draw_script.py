"""``draw_script``: frames recorded call by call from an application.
The mix's ``"lines"`` hold one frame each, a list of calls ``[name,
*args]`` on a render context (state calls such as ``save_state`` and
``translate`` among the draws), where a texture argument is a name in the
mix's ``"textures"``.  ``"static_calls"`` is drawn once into the frames'
initial framebuffer.

Frame k is recorded frame ``k % len(lines)``: every seed replays the
same frames in the application's order, so every run does the same work;
the seed makes the texels (the system draws them) and the sample."""

from __future__ import annotations


class Generator:
    def __init__(self, mix: dict, config: dict, seed: int):
        self.lines = mix["lines"]
        self.period = len(self.lines)

    def frame(self, k: int) -> list:
        return self.lines[k % len(self.lines)]
