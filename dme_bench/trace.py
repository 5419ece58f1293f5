"""What a ``torch.profiler`` window says of the device: busy and idle time,
each kernel's time, the longest idle stretches by what the host was doing.

``union`` and ``covered`` are frozen from ``chip_smoke.py`` (``_union``,
``_covered``; ``_trace_shares`` took busy time as the union of the device's
events over the window in the same way).  The benchmark's own spans enter
the trace as ``torch.profiler.record_function`` ranges named
``dme:<span>``, on the same clock as the device's events.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

PREFIX = "dme:"


def union(spans) -> "list[tuple[float, float]]":
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(spans, by) -> float:
    """Length of the union ``spans`` that the union ``by`` covers."""
    tot, j = 0.0, 0
    for a, b in spans:
        while j < len(by) and by[j][1] <= a:
            j += 1
        k = j
        while k < len(by) and by[k][0] < b:
            tot += min(b, by[k][1]) - max(a, by[k][0])
            k += 1
    return tot


@dataclasses.dataclass
class Trace:
    """Device events and the benchmark's host spans, as (name, start ns,
    end ns), and the traced window (the ``window`` span)."""
    device: list
    host: list

    @property
    def window(self) -> "tuple[int, int]":
        spans = [(a, b) for n, a, b in self.host if n == "window"]
        if len(spans) != 1:
            raise ValueError(f"the trace holds {len(spans)} window spans")
        return spans[0]

    def in_window(self) -> list:
        w0, w1 = self.window
        return [(n, max(a, w0), min(b, w1)) for n, a, b in self.device
                if b > w0 and a < w1]

    def busy_s(self) -> float:
        """Seconds of the window in which some kernel or copy ran."""
        return covered([self.window],
                       union((a, b) for _, a, b in self.device)) / 1e9

    def window_s(self) -> float:
        w0, w1 = self.window
        return (w1 - w0) / 1e9

    def kernel_s(self, part: str) -> "tuple[float, int]":
        """(seconds, launches) of the window's device events whose name
        holds ``part``."""
        hits = [b - a for n, a, b in self.in_window() if part in n]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, k: int = 10) -> "list[list]":
        """The ``k`` device operations, by name, that took most time."""
        tot = defaultdict(float)
        for n, a, b in self.in_window():
            tot[short(n)] += (b - a) / 1e9
        return [[n, s] for n, s in sorted(tot.items(), key=lambda t: -t[1])
                [:k]]

    def idle_by_span(self, k: int = 10) -> "list[list]":
        """Idle seconds of the window, summed by the innermost benchmark
        span the host was in at each idle stretch's middle, the ``k``
        largest."""
        w0, w1 = self.window
        busy = union((a, b) for _, a, b in self.in_window())
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < w1:
            gaps.append((t, w1))
        spans = sorted((a, b, n) for n, a, b in self.host
                       if n not in ("window", "round"))
        starts = [a for a, _, _ in spans]
        tot = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            # the latest span to start before the middle that still runs
            # there is the innermost one
            while i >= 0 and spans[i][1] <= mid:
                i -= 1
            tot[spans[i][2] if i >= 0 else "between spans"] += (b - a) / 1e9
        return [[n, s] for n, s in sorted(tot.items(), key=lambda t: -t[1])
                [:k]]


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    name = name.split("(", 1)[0].removeprefix("void ")
    return name if len(name) <= width else name[:width - 3] + "..."


def collect(prof) -> Trace:
    """The device's events and the benchmark's spans of a finished
    ``torch.profiler.profile``, from its raw events (building its event
    tree would take longer than the window)."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, b, name = e.start_ns(), e.end_ns(), e.name()
        if b <= a:
            continue
        if name.startswith(PREFIX):
            if not str(e.device_type()).endswith("CUDA"):
                host.append((name[len(PREFIX):], a, b))
        elif (str(e.device_type()).endswith("CUDA")
              and not e.is_user_annotation()):
            device.append((name, a, b))
    return Trace(device, host)
