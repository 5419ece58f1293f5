"""Bounded flight recorder: the last N events, dumped on anomaly.

The tracer streams every completed span into :meth:`FlightRecorder.record`
(plus any instrumented site can record ad-hoc events).  The ring buffer
keeps only the most recent ``capacity`` records — constant memory however
long the run — and :meth:`trigger` snapshots them the moment an anomaly
fires: a tier saturation REJECT, a payload-CRC seal failure, a forced
publish past the drain deadline.  The dump answers "what were the last N
things that happened before it went wrong" without tracing everything to
disk all the time.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Dump:
    """One anomaly snapshot: the reason plus the (oldest-first) last-N
    event records at trigger time."""
    reason: str
    at: float
    events: list
    attrs: dict = field(default_factory=dict)


DEFAULT_CAPACITY = 256


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity <= 0:
            raise ValueError("flight recorder capacity must be positive")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self.dumps: "list[Dump]" = []
        self.recorded = 0

    def record(self, event) -> None:
        """Append one record (a Span or any small event object)."""
        self._ring.append(event)
        self.recorded += 1

    def snapshot(self) -> list:
        """The current ring contents, oldest first."""
        return list(self._ring)

    def trigger(self, reason: str, at: float = 0.0, **attrs) -> Dump:
        """Anomaly: freeze the ring into a :class:`Dump` (the ring keeps
        rolling afterwards — back-to-back anomalies each get their own
        window)."""
        d = Dump(reason=reason, at=at, events=self.snapshot(), attrs=attrs)
        self.dumps.append(d)
        return d

    def last_dump(self) -> Optional[Dump]:
        return self.dumps[-1] if self.dumps else None

    def reset(self) -> None:
        self._ring.clear()
        self.dumps = []
        self.recorded = 0
