"""repro_torch.obs — unified observability for kernels → transport → engine → tree.

Zero-dependency (stdlib-only; ``span`` imports ``torch.profiler`` once
tracing is on) metrics + tracing + flight recorder + exporters, OFF by
default.  The switchboard:

    import repro_torch.obs as obs
    obs.enable()                      # metrics + tracing + flight recorder
    ... run rounds ...
    open("trace.json", "w").write(obs.export.chrome_trace(obs.tracer()))
    print(obs.export.prometheus_text(obs.registry()))
    obs.disable()

Cost model (the ≤5% acceptance bound): when disabled, instrumented hot
paths either hold a :data:`~repro_torch.obs.registry.NOOP` instrument or check
one module-level boolean — no allocation, no string formatting.  Tracing
and the recorder are strictly opt-in; metrics *scopes* (the per-round
``RoundStats``/``TierStats`` accounting) are always live because the stack
always kept those counts — ``scope()`` merely decides whether they land in
the process registry (exported) or in a detached private registry
(invisible, exactly the old cost).

Spans at the work: ``with obs.span("frame.crc", round=rid, client=cid):``
nests a span under the innermost ``obs.span`` open on the thread and, while
tracing is on, opens a ``torch.profiler.record_function`` range named
``repro:<name>`` around the same work, so a profiler trace holds the
program's spans on the clock of the device's events.  Off, it is one
boolean check returning a shared null context.

Clock injection: ``enable(clock=time.monotonic)`` stamps spans with wall
time; with no clock the tracer runs on virtual time fed by the open-loop
sim's event loop (``tracer().feed_time(t)``), so exported traces share the
event-time axis of the latency metrics.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Optional

from . import export  # noqa: F401  (re-exported submodule)
from .recorder import DEFAULT_CAPACITY, Dump, FlightRecorder  # noqa: F401
from .registry import (DEFAULT_BOUNDS, NOOP, Counter, Gauge,  # noqa: F401
                       Histogram, Registry, Scope, quantile)
from .trace import Span, Tracer, check_round  # noqa: F401

_metrics_on = False
_trace_on = False
_record_on = False

_registry = Registry()
_tracer = Tracer()
_recorder = FlightRecorder()
_scope_serial = itertools.count(1)


def metrics_enabled() -> bool:
    return _metrics_on


def tracing_enabled() -> bool:
    return _trace_on


def recording_enabled() -> bool:
    return _record_on


def enabled() -> bool:
    return _metrics_on or _trace_on or _record_on


def enable(metrics: bool = True, trace: bool = True, record: bool = True,
           recorder_capacity: Optional[int] = None,
           clock: Optional[Callable[[], float]] = None) -> None:
    """Switch observability on.  ``clock=None`` puts the tracer on fed
    virtual time (the sim's event loop feeds it); pass ``time.monotonic``
    or similar for wall-clock spans.  ``recorder_capacity`` rebuilds the
    flight-recorder ring at that size."""
    global _metrics_on, _trace_on, _record_on, _recorder
    _metrics_on = metrics
    _trace_on = trace
    _record_on = record
    _tracer.clock = clock
    if recorder_capacity is not None and \
            recorder_capacity != _recorder.capacity:
        _recorder = FlightRecorder(recorder_capacity)
    # stream completed spans into the ring so an anomaly dump shows the
    # last N pipeline events, not just the anomaly itself
    _tracer.sink = _recorder.record if (trace and record) else None


def disable() -> None:
    global _metrics_on, _trace_on, _record_on
    _metrics_on = _trace_on = _record_on = False
    _tracer.sink = None


def reset() -> None:
    """Zero all collected state (values, spans, ring) without breaking
    instrument identity — cached counter references stay valid."""
    _registry.reset()
    _tracer.reset()
    _recorder.reset()


def registry() -> Registry:
    return _registry


def tracer() -> Tracer:
    return _tracer


def recorder() -> FlightRecorder:
    return _recorder


def counter(name: str, **labels):
    """A live registry counter when metrics are on, else the no-op stub."""
    return _registry.counter(name, **labels) if _metrics_on else NOOP


def gauge(name: str, **labels):
    return _registry.gauge(name, **labels) if _metrics_on else NOOP


def histogram(name: str, bounds=DEFAULT_BOUNDS, **labels):
    return _registry.histogram(name, bounds=bounds, **labels) \
        if _metrics_on else NOOP


def scope(prefix: str, **labels) -> Scope:
    """An always-live instrument scope for one server/tier instance.

    The per-instance accounting behind ``RoundStats``/``TierStats`` must
    exist whether or not observability is on (the stack has always kept
    those counts), so this never returns a no-op: with metrics enabled the
    scope binds into the process registry (visible to the exporters) under
    a unique ``inst`` serial label; disabled, it binds a detached private
    registry — same cost, invisible."""
    if _metrics_on:
        return _registry.scope(prefix, inst=next(_scope_serial), **labels)
    return Registry().scope(prefix, **labels)


# prefix of the profiler ranges that obs.span opens
PREFIX = "repro:"
_NULL_SPAN = contextlib.nullcontext()


class _ProgramSpan:
    """A span of the tracer's span stack and the profiler range of the
    same name, opened and closed together."""
    __slots__ = ("name", "attrs", "sp", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        from torch.profiler import record_function
        self.rf = record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.sp = _tracer.open(self.name, **self.attrs)
        return self.sp

    def __exit__(self, *exc) -> bool:
        _tracer.close(self.sp)
        self.rf.__exit__(*exc)
        return False


def span(name: str, round: Optional[int] = None,
         client: Optional[int] = None):
    """A context manager around one piece of work, tagged with its round
    id (and client id where known).  With tracing off it is the shared
    null context: one boolean check, no allocation (hence named
    parameters and no ``**attrs``).  With tracing on it records a
    :class:`Span` under the innermost ``span`` open on the thread and
    opens the profiler range ``repro:<name>`` around the work."""
    if not _trace_on:
        return _NULL_SPAN
    attrs = {} if round is None else {"round": round}
    if client is not None:
        attrs["client"] = client
    return _ProgramSpan(name, attrs)


def trigger(reason: str, at: float = 0.0, **attrs):
    """Record an anomaly dump if the flight recorder is on (else None)."""
    if not _record_on:
        return None
    return _recorder.trigger(reason, at=at, **attrs)
