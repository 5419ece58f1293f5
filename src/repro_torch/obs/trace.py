"""Span-based tracing for the aggregation pipeline.

One :class:`Tracer` (usually the process singleton owned by
:mod:`repro_torch.obs`) collects :class:`Span` records driven by an injectable
clock: pass ``clock=time.monotonic`` for wall time, or no clock at all and
feed the sim's virtual heapq time through :meth:`Tracer.feed_time` — the
open-loop event loop does exactly that, so span timestamps are the same
deterministic event times the latency metrics are computed from.

Spans are causally linked per published round.  Instrumented sites address
spans by *key* (a small tuple like ``("round", rid)`` or
``("client", rid, cid)``) rather than by passing span objects through
layer boundaries — the client encoder, the transport reassembler and the
server drain never hold references to each other, so the keyspace is the
only practical join point.  The canonical tree for one round:

    round #rid                        ("round", rid)        [engine/server]
      encode cid                      ("client", rid, cid)  [client/sim]
        chunk (instant, per frame)                          [server/tier]
        reassembly cid                ("reassembly", rid, cid) [session]
        seal (instant)                                      [server/tier]
      fold tier=t                                           [tree tier]
      drain                                                 [server]
      publish (instant)                                     [finalize]

:func:`check_round` audits that tree for causal completeness — the
acceptance criterion every published round must meet in tests and the CI
smoke.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(slots=True)
class Span:
    """One timed (or instant) region.  ``end`` is None while open;
    ``instant`` marks zero-duration point events ("chunk", "seal",
    "publish", state transitions).  Slotted: the tracer creates one of
    these per chunk on the hot receive path, and instance-dict-free
    construction is what keeps enabled tracing inside the <= 5%
    overhead budget at mtu-forced chunk counts."""
    span_id: int
    name: str
    start: float
    end: Optional[float] = None
    parent_id: Optional[int] = None
    attrs: dict = field(default_factory=dict)
    instant: bool = False

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start


# a runaway-trace backstop far above any CI-sized round trace
MAX_SPANS = 200_000


class Tracer:
    """Ordered span store with key-addressed begin/end.

    ``begin(name, key=..., parent=<key or span_id>)`` opens a span;
    ``end(key)`` closes it (idempotent — a second end is a no-op, which is
    what makes ``finalize()`` safe to call from every publish path).
    ``event(...)`` records an instant span.  Keys stay resolvable after
    the span ends so late children (a straggler's seal after the round
    span closed) still attach to the right parent.

    ``open(name, ...)`` / ``close(span)`` nest instead of addressing: the
    parent of an opened span is the innermost span the same thread opened
    and has not closed (the stack behind :func:`repro_torch.obs.span`).

    If ``sink`` is set (the flight recorder's ``record``), every completed
    or instant span is also streamed there.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_spans: int = MAX_SPANS,
                 sink: Optional[Callable[["Span"], None]] = None):
        self.clock = clock
        self.max_spans = max_spans
        self.sink = sink
        self.spans: "list[Span]" = []
        self.dropped = 0
        self._vt = 0.0                       # fed virtual time (monotonic)
        self._by_key: dict = {}              # key -> Span (latest per key)
        self._ids = itertools.count(1)
        self._local = threading.local()      # .stack: this thread's open()

    # -- time ------------------------------------------------------------
    def now(self) -> float:
        return self.clock() if self.clock is not None else self._vt

    def feed_time(self, t: float) -> None:
        """Advance the virtual clock (no-op when a real clock is set);
        monotonic — stale feeds never move time backwards."""
        if t > self._vt:
            self._vt = t

    # -- spans -----------------------------------------------------------
    def _resolve_parent(self, parent) -> Optional[int]:
        if parent is None:
            return None
        if isinstance(parent, int):
            return parent
        sp = self._by_key.get(parent)
        if sp is None:
            # auto-create the missing ancestor so late/odd orderings (a
            # frame landing before the round span opened in a replay)
            # never orphan a child; the synthetic parent is an instant
            sp = self.begin(parent[0], key=parent, instant=True)
            sp.end = sp.start
        return sp.span_id

    def begin(self, name: str, key=None, parent=None, t: Optional[float] = None,
              instant: bool = False, **attrs) -> Optional[Span]:
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return None
        sp = Span(span_id=next(self._ids), name=name,
                  start=self.now() if t is None else t,
                  parent_id=self._resolve_parent(parent),
                  attrs=attrs, instant=instant)
        self.spans.append(sp)
        if key is not None:
            self._by_key[key] = sp
        return sp

    def end(self, span_or_key, t: Optional[float] = None, **attrs) -> None:
        sp = span_or_key if isinstance(span_or_key, Span) \
            else self._by_key.get(span_or_key)
        if sp is None or sp.end is not None:
            return
        sp.end = self.now() if t is None else t
        if attrs:
            sp.attrs.update(attrs)
        if self.sink is not None:
            self.sink(sp)

    def event(self, name: str, parent=None, t: Optional[float] = None,
              **attrs) -> Optional[Span]:
        sp = self.begin(name, parent=parent, t=t, instant=True, **attrs)
        if sp is not None:
            sp.end = sp.start
            if self.sink is not None:
                self.sink(sp)
        return sp

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, **attrs) -> Optional[Span]:
        """Open a span under the innermost span this thread opened and has
        not closed; None (and nothing recorded) past ``max_spans``."""
        stack = self._stack()
        top = stack[-1] if stack else None
        sp = self.begin(name, parent=top.span_id if top is not None else None,
                        **attrs)
        stack.append(sp)
        return sp

    def close(self, sp: Optional[Span]) -> None:
        """Close the innermost span :meth:`open` gave this thread (a
        :meth:`reset` in between has emptied the stack already)."""
        stack = self._stack()
        if stack:
            stack.pop()
        if sp is not None:
            self.end(sp)

    def get(self, key) -> Optional[Span]:
        return self._by_key.get(key)

    def children(self, span_id: int) -> "list[Span]":
        return [s for s in self.spans if s.parent_id == span_id]

    def reset(self) -> None:
        self.spans = []
        self.dropped = 0
        self._vt = 0.0
        self._by_key = {}
        self._ids = itertools.count(1)
        self._local = threading.local()


def _under(tracer: Tracer, root_id: int) -> "list[Span]":
    """All spans in the subtree rooted at ``root_id``."""
    kids: dict = {}
    for s in tracer.spans:
        kids.setdefault(s.parent_id, []).append(s)
    out, stack = [], [root_id]
    while stack:
        sid = stack.pop()
        for s in kids.get(sid, ()):
            out.append(s)
            stack.append(s.span_id)
    return out


def check_round(tracer: Tracer, round_id: int, accepted=(),
                require_fold: bool = False) -> "list[str]":
    """Audit one published round's span tree for causal completeness.

    Returns a list of problems (empty = complete): the round span must
    exist and be closed; no span under it may have a dangling parent_id;
    a "publish" instant must be present; a "drain" span must be present
    when any client was accepted; a "fold" span when ``require_fold`` (the
    tree path); and every accepted client must show encode → >=1 chunk →
    seal.  Extra spans (e.g. from a parity replay of the same round) are
    tolerated — completeness, not exclusivity, is the contract.
    """
    problems: "list[str]" = []
    root = tracer.get(("round", round_id))
    if root is None:
        return [f"round {round_id}: no round span"]
    if root.end is None:
        problems.append(f"round {round_id}: round span never ended")

    ids = {s.span_id for s in tracer.spans}
    sub = _under(tracer, root.span_id)
    for s in sub:
        if s.parent_id is not None and s.parent_id not in ids:
            problems.append(f"round {round_id}: span {s.name}#{s.span_id} "
                            f"has orphan parent {s.parent_id}")

    names = {}
    for s in sub:
        names.setdefault(s.name, []).append(s)
    if "publish" not in names:
        problems.append(f"round {round_id}: no publish event")
    if accepted and "drain" not in names:
        problems.append(f"round {round_id}: no drain span")
    if require_fold and "fold" not in names:
        problems.append(f"round {round_id}: no fold span")

    for cid in accepted:
        enc = tracer.get(("client", round_id, cid))
        if enc is None:
            problems.append(f"round {round_id}: client {cid} has no "
                            f"encode span")
            continue
        client_sub = _under(tracer, enc.span_id)
        kinds = {s.name for s in client_sub}
        if "chunk" not in kinds:
            problems.append(f"round {round_id}: client {cid} has no chunk "
                            f"events")
        if "seal" not in kinds:
            problems.append(f"round {round_id}: client {cid} was never "
                            f"sealed")
    return problems
