"""Faults planted under the timed path, for the check's own test: each
should make ``correct`` come out false.  ``planted(system, kind)`` is a
context manager that patches the port's module and restores it.

* ``unchanged``: the render leaves its state unchanged (a mesh batch's
  later frames repeat its first; a chart frame is never executed, so it
  is its initial framebuffer);
* ``half``: half of each batch left out (a mesh batch's second half
  zero; every other chart frame not executed);
* ``altered``: an answer altered where it is produced (a 32x32 block of
  every frame's bytes flipped).

No cell has an exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

KINDS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield real
    finally:
        setattr(obj, name, real)


def _mesh(kind):
    from libnativecpurenderer_tpu_torch.ops import raster3d
    stack = contextlib.ExitStack()
    for name in ("render_gouraud_u8_loop", "render_textured_u8_loop"):
        real = getattr(raster3d, name)

        def fake(*a, _real=real, **kw):
            frames, ovf = _real(*a, **kw)
            frames = frames.clone()
            if kind == "unchanged":
                frames[1:] = frames[:1]
            elif kind == "half":
                frames[frames.shape[0] // 2:] = 0
            else:
                frames[:, 8:40, 8:40] ^= 0x55
            return frames, ovf
        stack.enter_context(_patched(raster3d, name, fake))
    return stack


def _chart(kind):
    from libnativecpurenderer_tpu_torch import pipeline
    from libnativecpurenderer_tpu_torch.ops import executor
    if kind == "unchanged":
        return _patched(pipeline, "execute", lambda *a, **kw: None)
    if kind == "half":
        real, n = pipeline.execute, [0]

        def every_other(*a, **kw):
            n[0] += 1
            if n[0] % 2:
                real(*a, **kw)
        return _patched(pipeline, "execute", every_other)
    real_q = executor.quantize_u8

    def altered(fb, *a, **kw):
        u8 = real_q(fb, *a, **kw).clone()
        u8[8:40, 8:40] ^= 0x55
        return u8
    return _patched(executor, "quantize_u8", altered)


def planted(system: str, kind: str):
    """A context manager planting ``kind`` under the system named
    ``system`` (a configuration's ``"system"``)."""
    if kind not in KINDS:
        raise ValueError(f"no fault {kind!r} ({', '.join(KINDS)})")
    return {"mesh_video": _mesh, "chart_video": _chart}[system](kind)
