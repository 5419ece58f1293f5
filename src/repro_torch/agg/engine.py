"""Event-driven continuous-round aggregation engine; counterpart of
``repro.agg.engine``.

A round is a time/quorum window over whoever shows up: the engine keeps
several live :class:`~repro_torch.agg.service.Round` instances keyed by
``round_id``, routes every arriving frame by its self-describing header
(:func:`repro_torch.agg.transport.frame.peek_route` — a lying header just
fails its CRC at the server it routes to), and turns rounds over on
**quorum-or-deadline**:

* the OPEN round admits newcomers; once ``quorum`` distinct clients are
  admitted — or ``round_deadline`` elapses with at least ``min_clients`` —
  it **seals** and the next round opens at once;
* SEALING rounds serve only their admitted clients; an admitted client idle
  past ``straggler_deadline`` consumes one unit of a per-client
  ``STATUS_RESEND`` budget (``max_resends``), after which it is
  **expired** without a verdict;
* rounds **publish strictly in round-id order** — when every admitted
  client resolves, or at ``drain_deadline`` after the seal — and each
  published mean feeds the service's QState (the anchor chain);
* **admission control + backpressure**: the per-round pending store is
  bounded (``max_pending``) and so is the live-round window
  (``max_live_rounds``; the oldest round is force-published).  A frame that
  cannot be admitted draws a non-terminal ``STATUS_RETRY`` naming the round
  open for admission.

The engine only decides *which* clients make a round, never *how* they are
summed, so every published mean is bit-identical to a lockstep replay over
that round's accepted clients.  It is plain Python over the service and
clock-agnostic: every entry point takes ``now``, and there are no threads
and no timers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import repro_torch.obs as _obs
from repro_torch.agg.api import PublishedLog, PublishedRound  # noqa: F401
#           (re-exported here, as the reference re-exports it)
from repro_torch.agg.service import AggService, Round, RoundState
from repro_torch.agg.transport import frame as wire


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Cutover / drain / admission policy of the continuous-round engine."""
    quorum: int = 64              # seal the open round at this many distinct
                                  # admitted clients (the fast path)
    round_deadline: float = 1.0   # ... or after this long open (the slow
                                  # path), whichever comes first
    min_clients: int = 1          # a deadline cutover needs at least this
                                  # many admitted clients; an emptier round
                                  # re-arms instead of spinning
    straggler_deadline: float = 0.25  # per-client idle time in a sealing
                                      # round before the RESEND budget is
                                      # tapped (and, exhausted, the client
                                      # expires)
    max_resends: int = 2          # deadline-driven STATUS_RESEND budget per
                                  # client per round
    drain_deadline: float = 1.0   # max time a round may seal/drain before
                                  # it is force-published without its
                                  # unresolved stragglers
    max_pending: Optional[int] = None  # per-round pending-store cap
                                       # (admission backpressure)
    max_live_rounds: int = 3      # live (unpublished) round window; the
                                  # oldest is force-published past this


class AggEngine:
    """The continuous-round event loop over an :class:`AggService`.

    Usage (the sim's open-loop driver)::

        eng = AggEngine(AggService(cfg), EngineConfig(...), now=0.0)
        for event_time, frame in arrivals:
            responses += eng.receive(frame, now=event_time)
        responses += eng.advance(now)       # fire time-based policy
        ... eng.published holds the in-order PublishedRound record ...
    """

    def __init__(self, svc: AggService, cfg: EngineConfig, now: float = 0.0):
        if cfg.max_live_rounds < 2:
            raise ValueError("max_live_rounds must be >= 2 (one sealing + "
                             "one open) for overlapping intake")
        self.svc = svc
        self.cfg = cfg
        self.live: "dict[int, Round]" = {}
        self._order: "list[Round]" = []      # oldest ... newest (== open)
        # PublishedLog: a list (``eng.published[k]``, the historical
        # surface) that is also the AggNode verb (``eng.published()``)
        self.published: PublishedLog = PublishedLog()
        self.max_live_seen = 1
        self.retried_unknown_round = 0       # engine-level RETRYs (frames
                                             # for dead/future rounds)
        self._activity: "dict[tuple[int, int], float]" = {}
        self._resends: "dict[tuple[int, int], int]" = {}
        self._publish_times: "dict[int, float]" = {}
        self._open_new(now)

    # ------------------------------------------------------------- STATE
    @property
    def open_round(self) -> Round:
        """The single round currently admitting new clients."""
        return self._order[-1]

    @property
    def live_rounds(self) -> int:
        return len(self._order)

    def _open_new(self, now: float) -> None:
        rnd = self.svc.open_round(now=now, max_pending=self.cfg.max_pending)
        self.live[rnd.round_id] = rnd
        self._order.append(rnd)
        if _obs.tracing_enabled():
            _obs.tracer().begin("round", key=("round", rnd.round_id),
                                t=now, round=rnd.round_id)

    # ------------------------------------------------------------ AggNode
    # The engine's native verbs (receive/advance/published) predate the
    # protocol; these aliases make it a drop-in AggNode so the sim and the
    # examples can drive a flat engine and a tree root interchangeably.
    def ingest_frame(self, data: bytes, now: float = 0.0) -> "list[bytes]":
        """AggNode verb: route one frame (alias of :meth:`receive`)."""
        return self.receive(data, now)

    def tick(self, now: float = 0.0) -> "list[bytes]":
        """AggNode verb: fire due events (alias of :meth:`advance`)."""
        return self.advance(now)

    # ---------------------------------------------------------------- RX
    def receive(self, data: bytes, now: float) -> "list[bytes]":
        """Route one frame; returns every response generated (the frame's
        own, plus any cutover/drain verdicts the event fired)."""
        out = self.advance(now)     # advance() feeds the tracer's clock
        peek = wire.peek_route(data)
        if peek is None:
            # not even a v3 frame prefix: let the open round's server
            # produce the proper wire REJECT (and count it)
            out.append(self.open_round.server.receive(data))
            return out
        round_id, client_id = peek
        rnd = self.live.get(round_id)
        if rnd is None:
            # a round already published (straggler outliving its round) or
            # not yet opened (reordered future traffic): non-terminal —
            # point the client at the round open for admission
            self.retried_unknown_round += 1
            if _obs.metrics_enabled():
                _obs.counter("engine_retried_unknown_round").inc()
            out.append(wire.encode_response(wire.Response(
                status=wire.STATUS_RETRY, round_id=round_id,
                client_id=client_id, attempt_next=0,
                q_next=self.open_round.round_id, y_next=0.0)))
            return out
        out.append(rnd.server.receive(data))
        self._activity[(round_id, client_id)] = now
        if (rnd is self.open_round
                and rnd.server.admitted_count >= self.cfg.quorum):
            out.extend(self.cutover(now, cause="quorum"))
        return out

    # ------------------------------------------------------------ EVENTS
    def advance(self, now: float) -> "list[bytes]":
        """Fire every due time-based event: straggler deadlines and drains
        on sealing rounds, in-order publishing, and deadline cutover."""
        if _obs.tracing_enabled():
            _obs.tracer().feed_time(now)
        out = self._service_sealing(now)
        self._publish_pass(now)
        rnd = self.open_round
        if now - rnd.opened_at >= self.cfg.round_deadline:
            if rnd.server.admitted_count >= self.cfg.min_clients:
                out.extend(self.cutover(now, cause="deadline"))
            else:
                rnd.opened_at = now          # nobody showed up: re-arm
        return out

    def cutover(self, now: float, cause: str = "quorum") -> "list[bytes]":
        """Seal the open round (quorum or deadline met) and open the next.

        The seal-time drain pushes every decodable payload into the
        accumulator and sends the escalation NACKs / chunk RESENDs that
        start the overlapping-drain phase."""
        rnd = self.open_round
        rnd.seal(now, next_round_id=rnd.round_id + 1)
        if _obs.metrics_enabled():
            _obs.counter("engine_cutovers", cause=cause).inc()
        if _obs.tracing_enabled():
            _obs.tracer().event("cutover", parent=("round", rnd.round_id),
                                t=now, round=rnd.round_id, cause=cause,
                                admitted=rnd.server.admitted_count)
        out = rnd.server.drain()
        self._publish_pass(now)
        while len(self._order) >= self.cfg.max_live_rounds:
            # window full: the oldest round leaves now, resolved or not
            head = self._order[0]
            _obs.trigger("forced_publish_window_full", at=now,
                         round=head.round_id,
                         unresolved=len(head.server.unresolved))
            self._publish(head, now, forced=bool(head.server.unresolved))
        self._open_new(now)
        # earlier sealed rounds' RETRY hints follow the admission window
        for r in self._order[:-1]:
            r.server.seal(self.open_round.round_id)
        self.max_live_seen = max(self.max_live_seen, len(self._order))
        return out

    def _service_sealing(self, now: float) -> "list[bytes]":
        """Drains + straggler deadlines for every sealing round."""
        out = []
        for rnd in self._order[:-1]:
            if rnd.state is not RoundState.SEALING:
                continue
            if rnd.server.pending:
                # straggler payloads that completed since the last event:
                # decode them now so their verdicts (and any escalation)
                # go out before the drain deadline
                out.extend(rnd.server.drain())
            for cid in sorted(rnd.server.unresolved):
                key = (rnd.round_id, cid)
                last = self._activity.get(key, rnd.sealed_at)
                if now - last < self.cfg.straggler_deadline:
                    continue
                spent = self._resends.get(key, 0)
                if spent >= self.cfg.max_resends:
                    rnd.server.expire_client(cid)     # no verdict: the
                    continue                          # client may re-enroll
                self._resends[key] = spent + 1
                self._activity[key] = now
                rr = rnd.server.resend_request(cid)
                if rr is not None:
                    out.append(rr)
        return out

    def _publish_pass(self, now: float) -> None:
        """Publish every head-of-line round that is drained (or past its
        drain deadline) — strictly in round-id order."""
        while self._order:
            head = self._order[0]
            if head.state is RoundState.OPEN:
                break
            if not head.server.unresolved:
                if head.state is RoundState.SEALING:
                    head.mark_drained(now)
                self._publish(head, now)
            elif now - head.sealed_at >= self.cfg.drain_deadline:
                # force: expires stragglers
                _obs.trigger("forced_publish_drain_deadline", at=now,
                             round=head.round_id,
                             unresolved=len(head.server.unresolved))
                self._publish(head, now, forced=True)
            else:
                break

    def _publish(self, rnd: Round, now: float, forced: bool = False) -> None:
        anchor = rnd.client_anchor
        mean, stats = self.svc.publish_round(rnd, now)
        self.live.pop(rnd.round_id)
        self._order.remove(rnd)
        self._publish_times[rnd.round_id] = now
        stale = (now - self._publish_times[rnd.anchor_round]
                 if rnd.anchor_round in self._publish_times else 0.0)
        if _obs.metrics_enabled():
            _obs.counter("engine_rounds_published",
                         forced="1" if forced else "0").inc()
            _obs.histogram("round_latency_s").observe(now - rnd.opened_at)
            _obs.gauge("anchor_staleness_s").set(stale)
        self.published.append(PublishedRound(
            round_id=rnd.round_id, spec=rnd.spec, anchor=anchor, mean=mean,
            stats=stats, accepted=rnd.server.accepted_clients,
            opened_at=rnd.opened_at, sealed_at=rnd.sealed_at,
            published_at=now, anchor_round=rnd.anchor_round,
            staleness=stale))
        for key in [k for k in self._activity if k[0] == rnd.round_id]:
            del self._activity[key]
        for key in [k for k in self._resends if k[0] == rnd.round_id]:
            del self._resends[key]

    # ---------------------------------------------------------- SHUTDOWN
    def flush(self, now: float) -> "list[PublishedRound]":
        """End of traffic: seal + force-publish every live round, in order
        (the open round included — its admitted clients get one last
        drain).  Returns the full published history."""
        if _obs.tracing_enabled():
            _obs.tracer().feed_time(now)
        rnd = self.open_round
        if rnd.server.admitted_count:
            rnd.seal(now, next_round_id=rnd.round_id + 1)
            rnd.server.drain()
        for r in list(self._order):
            if r.state is not RoundState.OPEN:
                self._publish(r, now, forced=bool(r.server.unresolved))
        return self.published
