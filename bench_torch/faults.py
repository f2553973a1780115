"""Faults planted under the timed path, for the check's own test: each
should make ``correct`` come out false.  ``planted(system, kind)`` is a
context manager that patches the port's module and restores it; what it
patches is the system's own, its module's ``fault(kind)``
(``systems/<system>.py``).

A frame is the unit a system delivers to the sink (a u8 video frame, or
one mixed clip).  The kinds:

* ``unchanged``: the work leaves its state unchanged (a frame repeats an
  earlier one, or is its initial buffer);
* ``half``: half of each batch left out;
* ``altered``: an answer altered where it is produced (a block of every
  frame's bytes flipped: 32x32 pixels of a video frame).

No cell has an exchange between chips to leave out.
"""

from __future__ import annotations

from .harness import spec

KINDS = ("unchanged", "half", "altered")


def planted(system: str, kind: str):
    """A context manager planting ``kind`` under the system named
    ``system`` (a configuration's ``"system"``)."""
    if kind not in KINDS:
        raise ValueError(f"no fault {kind!r} ({', '.join(KINDS)})")
    return spec.system_part(system, "fault")(kind)
