"""The traced window: device operations, host operations and the harness's
marks from one torch.profiler capture, on one clock.

The harness marks the window's start and the end of every iteration (the
moment its LLH reached the host) with a `record_function` of the name
MARK. Device operations are CUDA kernels, copies and fills; the device is
busy where one runs. Metric readers (metrics/*.py) take their numbers
from a Trace.
"""

from __future__ import annotations

import bisect
import re
from pathlib import Path
from typing import NamedTuple

MARK = "clambench/mark"


class Trace(NamedTuple):
    device_ops: list     # (name, start_ns, end_ns), by start, inside the window
    host_ops: list       # (name, start_ns, end_ns), by start
    marks: list          # ns: the window's start, then each iteration's end

    @property
    def window(self) -> tuple:
        return self.marks[0], self.marks[-1]

    @property
    def window_s(self) -> float:
        t0, t1 = self.window
        return (t1 - t0) / 1e9

    def busy(self) -> list:
        """Merged (start, end) intervals in which some device operation ran."""
        out = []
        for _, a, b in self.device_ops:
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1][1] = b
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def idle(self) -> list:
        """(start, end) gaps inside the window with no device operation."""
        t0, t1 = self.window
        gaps, last = [], t0
        for a, b in self.busy():
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if t1 > last:
            gaps.append((last, t1))
        return gaps

    def host_at(self, t: int, starts: list) -> str:
        """The innermost host operation running at t, or 'python'
        (`starts`: the host operations' start times)."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            name, a, b = self.host_ops[j]
            if a <= t <= b:
                return name
        return "python"


def _clip(ops: list, t0: int, t1: int) -> list:
    out = [(n, max(a, t0), min(b, t1)) for n, a, b in ops if b > t0 and a < t1]
    out.sort(key=lambda op: op[1])
    return out


def _events(prof) -> tuple:
    """(device ops, host ops, marks) from the capture's kineto events, on
    one clock (start_ns)."""
    device, host, marks = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name, a = ev.name(), ev.start_ns()
        b = a + ev.duration_ns()
        if "cuda" in str(ev.device_type()).lower():
            # a record_function's range on the device is no operation
            if not ev.is_user_annotation():
                device.append((name, a, b))
        elif name == MARK:
            marks.append(a)
        else:
            host.append((name, a, b))
    return device, host, marks


def collect(prof) -> Trace:
    """The Trace of a finished capture."""
    device, host, marks = _events(prof)
    marks.sort()
    if len(marks) < 2:
        raise RuntimeError("the capture holds fewer than two window marks")
    t0, t1 = marks[0], marks[-1]
    host.sort(key=lambda op: op[1])
    return Trace(_clip(device, t0, t1), host, marks)


def port_kernel_names(csrc: Path) -> set:
    """The names of the program's hand-written CUDA kernels (`__global__`
    functions in its csrc/*.cu)."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")
    names = set()
    for path in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(path.read_text()))
    return names


def port_kernel_matcher(port: set):
    """A test of a device operation's (demangled) name: is it one of the
    port's kernels, the name standing before its template or argument
    list?"""
    pat = re.compile(r"\b(?:%s)\s*[<(]" % "|".join(sorted(map(re.escape, port))))
    return lambda op_name: bool(port) and pat.search(op_name) is not None


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing (the innermost host operation at the
    gap's middle), each summed by name: [[name, seconds], ...]."""
    ops = {}
    for name, a, b in trace.device_ops:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e9
    gaps, starts = {}, [op[1] for op in trace.host_ops]
    for a, b in trace.idle():
        label = trace.host_at((a + b) // 2, starts)
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    order = lambda d: [[n[:200], s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}
