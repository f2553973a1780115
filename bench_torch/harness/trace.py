"""What a ``torch.profiler`` trace of a steady sub-window says: host
launch and copy calls, the device's busy intervals (kernels, copies and
fills: the union of their intervals, so a copy counts as busy), device
time by operation and by the kernels of one of the program's libraries,
and the idle gaps named by the benchmark span the host was in.

The sub-window is marked by a ``bench.window`` range; the benchmark's
spans are ``bench.*`` ranges.  Kernel names of a library come from its
ptxas log beside the built library the process has loaded (the
``Compiling entry function`` lines), so a renamed kernel stays matched.
"""

from __future__ import annotations

import re
from pathlib import Path

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync")
WINDOW = "bench.window"
NAME_CHARS = 160          # a device operation's name in the breakdown


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def idle_by_span(busy, spans, lo, hi):
    """Idle seconds of the device in [lo, hi] (microseconds) that are not
    in ``busy`` (merged), summed by the innermost host span (name, start,
    end) that holds each gap's midpoint ("no span" where none does)."""
    out: dict = {}
    t = lo
    gaps = []
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = (min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner
                else "no span")
        out[name] = out.get(name, 0.0) + (e - s) * 1e-6
    return out


def source_name(mangled: str) -> str:
    """The function's own identifier in an Itanium-mangled name (the
    last component of a nested name, before its template arguments);
    a name that is not mangled stands for itself."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 2
    nested = mangled.startswith("N", i)
    i += nested
    last = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        last, i = mangled[j:j + n], j + n
        if not nested:
            break
    return last


def entry_names(log: str) -> set:
    """The identifiers of the kernel entries an nvcc -Xptxas=-v log
    compiled."""
    return {source_name(m.group(1)) for m in re.finditer(
        r"Compiling entry function '(\w+)'", log)}


def loaded_library_log(lib: str) -> str | None:
    """The ptxas log beside the ``_build/<lib>-<hash>.so`` this process
    has mapped, or None if it maps none."""
    try:
        maps = Path("/proc/self/maps").read_text()
    except OSError:
        return None
    m = re.search(rf"(/\S*/_build/{re.escape(lib)}-[0-9a-f]+)\.so", maps)
    if m is None:
        return None
    log = Path(m.group(1) + ".log")
    return log.read_text() if log.exists() else None


class Trace:
    """The numbers of one profiled sub-window."""

    def __init__(self, events, frames: int):
        self.frames = frames
        win = [e for e in events
               if e.name == WINDOW and e.device_type.name != "CUDA"]
        if not win:
            raise ValueError("the trace has no bench.window range")
        lo, hi = win[0].time_range.start, win[0].time_range.end
        self.window_s = (hi - lo) * 1e-6
        self.launch_calls = 0
        dev, spans = [], []
        self.device_by_name: dict = {}
        for e in events:
            if e.name in LAUNCH_CALLS:
                self.launch_calls += 1
            if e.name.startswith("bench."):
                # the ranges' device-side annotations are no device work
                if e.device_type.name != "CUDA" and e.name != WINDOW:
                    spans.append((e.name, e.time_range.start,
                                  e.time_range.end))
            elif e.device_type.name == "CUDA":
                s, t = e.time_range.start, e.time_range.end
                dev.append((s, t))
                self.device_by_name[e.name] = (
                    self.device_by_name.get(e.name, 0.0) + (t - s) * 1e-6)
        busy = merge(clip(dev, lo, hi))
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self.device_ops = bool(dev)
        self.idle_by_span = idle_by_span(busy, spans, lo, hi)

    def library_kernel_s(self, lib: str) -> float | None:
        """Device seconds of the kernels of the loaded library ``lib``,
        None where it is not loaded or none of its kernels ran."""
        log = loaded_library_log(lib)
        if log is None:
            return None
        names = entry_names(log)
        pats = [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])")
                for n in names]
        total = sum(s for name, s in self.device_by_name.items()
                    if any(p.search(name) for p in pats))
        return total or None

    def breakdown(self) -> dict:
        ops = sorted(self.device_by_name.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops[:10]],
                "idle_gaps": [[n, s] for n, s in gaps[:10]]}
