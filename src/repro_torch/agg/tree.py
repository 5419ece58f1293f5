"""Hierarchical sum-without-decode aggregation tree; counterpart of
``repro.agg.tree``.

Topology: clients -> edge tiers -> (regional tiers ->) root, every hop the
ordinary transport (chunking, selective retransmit, escalation)::

    client 0 ─┐
    client 1 ─┼─> TierAggregator ─┐
    client 2 ─┘        (edge)     │
                                  ├─> TierAggregator ──> root AggServer
    client 3 ─┐        (edge)     │      (regional)      (ONE batched
    client 4 ─┼─> TierAggregator ─┘                       decode launch
    client 5 ─┘                                           per color space)

A :class:`TierAggregator` accepts chunked client frames through the
unchanged session/reassembly layer, validates CRCs and the sides sidecar
against the round's pinned spec, and **sums accepted payloads' integer
coordinates without ever decoding**:

* The round's decode-reference coordinates ``k0 = round(ref/s - u)``
  (:func:`repro_torch.agg.rounds.decode_ref_coords`) are bit-identical to
  the ``k_a`` inside the root's batched decode.  Each accepted child's
  colors lift to ``r_i = centered_mod(c_i - k0, q)``
  (:func:`repro_torch.kernels.ops.lattice_residuals`: plain torch integer
  ops, not a decode dispatch), so ``k0 + r_i`` IS the root's decode output
  for that payload.
* The §5 checksum ``h(k0 + r_i)`` is verified per child mod 2^32
  (:func:`repro_torch.core.error_detect.coord_checksum`, in int64, since
  torch has no unsigned 32-bit arithmetic); a mismatch draws the flat
  server's NACK escalation schedule.
* Accepted residuals fold into the int64 accumulator ``R`` and
  ``m += n_summed``; a child whose fold would push ``R`` outside the
  escalation cap's centered range ``q_max/2`` is REJECTed (counted in
  :attr:`TierStats.saturated`).
* Upstream the tier is an ordinary client: it forwards ONE combined payload
  ``K' = k0 + R`` packed as mod-q' colors at the smallest escalation
  attempt whose color space holds ``R``, with checksum ``h(K')`` and the
  header field ``n_summed = m``.

The tier's state — ``k0`` (int32), the checksum weights and ``R`` (int64),
each (padded,) — lives on the tier's device.  The root corrects each
combined payload by ``(m-1) * k0`` inside its drain, so the tree-published
mean is bit-identical to a flat drain over the same accepted clients.
:class:`AggTree` wires tiers into the fanout^j topology behind the
:class:`repro_torch.agg.api.AggNode` protocol.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

import repro_torch.obs as _obs
from repro_torch import resolve_device
from repro_torch.agg import rounds
from repro_torch.agg.api import PublishedRound
from repro_torch.agg.server import AggServer, _StreamFold, _reject, _retry
from repro_torch.agg.transport import chunks as C
from repro_torch.agg.transport import frame as wire
from repro_torch.agg.transport import session as S
from repro_torch.core import error_detect as ED
from repro_torch.core import lattice as L
from repro_torch.kernels import ops as K

_M32 = 0xFFFFFFFF

# tier node ids live far above any realistic client id so the two can share
# the transport's u32 client_id field without collisions; layer index and
# position are recoverable from the id for debugging
TIER_ID_BASE = 0xF0000000

# upper bound on tick-internal message exchange iterations (a persistent
# loss hook could otherwise ping-pong RESENDs forever within one tick)
_MAX_PUMP = 64

# a sealed-and-forwarded tier with no verdict after this many consecutive
# ticks re-sends its full upstream frame sequence (recovers total loss of
# the combined payload, where no reassembly exists upstream to RESEND)
_UP_RESEND_TICKS = 2


@dataclasses.dataclass
class TierStats:
    """One tier's child-side + upstream telemetry."""
    received: int = 0
    queued: int = 0
    accepted: int = 0            # child payloads folded into R
    clients_summed: int = 0      # sum of folded n_summed (== forwarded m)
    duplicates: int = 0
    rejected_wire: int = 0
    rejected_spec: int = 0
    decode_failures: int = 0     # §5 checksum mismatches (integer-verified)
    nacks_sent: int = 0
    resends_sent: int = 0
    retried: int = 0
    saturated: int = 0           # children REJECTed by the overflow guard
    gave_up: int = 0
    expired: int = 0
    drains: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    up_frames_sent: int = 0      # upstream chunk frames (incl. retransmits)
    up_escalations: int = 0      # upstream NACKs honored (repack at next q)
    up_resends: int = 0          # upstream RESEND/timer retransmissions


class TierAggregator:
    """One aggregation tier: a server to its children, a client upstream.

    Implements the :class:`repro_torch.agg.api.AggNode` protocol.
    ``anchor`` (numpy or tensor) is the same out-of-band reference the root
    holds (digest-validated for anchored rounds); ``node_id`` is this
    tier's client id on the upstream wire.  The tier's state lives on
    ``device`` — the CUDA device unless the caller names another.
    """

    def __init__(self, spec: wire.RoundSpec, anchor, node_id: int,
                 max_pending: "int | None" = None,
                 streaming: "bool | None" = None, device=None):
        """``streaming`` mirrors :class:`~repro_torch.agg.server.AggServer`:
        ``None`` resolves to ``spec.window > 0`` — a windowed round folds
        each child stream's validated word ranges as they land (the tier
        never decoded anyway, so streaming only moves the residual lift
        from drain time to arrival time and frees the chunk bytes early);
        commit into ``R`` still happens only at stream completion, after
        the §5 checksum and the saturation guard (which needs the full
        residual vector) pass."""
        rounds.check_anchor(spec, anchor if spec.anchored else None)
        self.spec = spec
        self.device = dev = resolve_device(device)
        self.node_id = node_id
        self.max_pending = max_pending
        self._sealed = False
        self._next_round_id = 0
        # the integer-space lift reference: bit-identical to the k_a inside
        # the root's batched decode (both anchored and unanchored rounds)
        ref = None if spec.anchored else rounds.as_f32(anchor, dev)
        self._k0 = rounds.decode_ref_coords(spec, ref, dev)   # (padded,) i32
        self._weights = rounds.checksum_weights(spec, dev)    # int32 bits
        self._sides_np = spec.sides_np()
        # escalation headroom: the widest color space any attempt may use;
        # |R| must stay inside its centered range or the repacked colors
        # would alias and the root's decode would silently wrap
        self._q_max = wire.q_at_attempt(spec.cfg.q, spec.max_attempts - 1)
        # ---- child side (mirrors AggServer's intake) ----
        self._admitted: set[int] = set()
        self._accepted: set[int] = set()
        self._gave_up: set[int] = set()
        self._pending: dict[int, wire.Payload] = {}
        self._attempt_floor: dict[int, int] = {}
        self._folds: "dict[tuple, _StreamFold]" = {}
        self._streaming = ((spec.window > 0) if streaming is None
                           else bool(streaming)) and spec.mtu > 0
        if self._streaming:
            self._rx = S.Reassembler(spec,
                                     on_range_validated=self._fold_range,
                                     on_stream_discarded=self._drop_stream)
        else:
            self._rx = S.Reassembler(spec)
        self._margins: dict[int, tuple] = {}
        # ---- the sum-without-decode accumulator ----
        self._R = torch.zeros((spec.padded,), dtype=torch.int64, device=dev)
        self._m = 0
        # ---- upstream (client-of-the-next-tier) state ----
        self._up_attempt: Optional[int] = None
        self._up_frames: "dict[int, list[bytes]]" = {}
        self._up_sent = False
        self._up_acked = False
        self._up_gave_up = False
        self._up_idle_ticks = 0
        self.retry_round: Optional[int] = None
        # tier accounting lives in an obs scope (exported registry counters
        # when metrics are on, a detached registry otherwise); the TierStats
        # dataclass callers read is filled from it on access
        self._obs = _obs.scope("agg_tier", round=spec.round_id,
                               node=node_id)
        self._stats = TierStats()

    @property
    def stats(self) -> TierStats:
        """This tier's telemetry, materialized from the obs scope."""
        self._obs.fill(self._stats)
        return self._stats

    @property
    def tier_index(self) -> int:
        """(layer, position) packed in the node id — for labels/debug."""
        return self.node_id & ~TIER_ID_BASE

    # ------------------------------------------------------------ AggNode
    def ingest_frame(self, data: bytes, now: float = 0.0) -> "list[bytes]":
        """One transport message in: a child's frame (returns its response)
        or an upstream response (returns the frames to send next)."""
        if data[:4] == wire.MAGIC_RESPONSE:
            return self.handle_upstream(data)
        return [self.ingest_child(data)]

    def tick(self, now: float = 0.0) -> "list[bytes]":
        """Fold staged children, chase missing chunks, forward upstream."""
        out = self.drain_children()
        out.extend(self._upstream_tick())
        return out

    def published(self) -> "list[PublishedRound]":
        """Tiers never publish — the root owns the round outcome."""
        return []

    # ---------------------------------------------------------- CHILD SIDE
    def ingest_child(self, data: bytes) -> bytes:
        """Handle one arriving child frame; returns the response bytes.

        Identical admission/session behavior to :meth:`AggServer.receive`:
        framing and spec violations draw wire/spec REJECTs, chunked bodies
        reassemble out of order through the session layer, duplicates ACK
        idempotently, and a sealed tier or full pending store answers a
        non-terminal RETRY.
        """
        self._obs.inc("received")
        self._obs.inc("bytes_in", len(data))
        try:
            h, chunk = wire.decode_frame(data)
        except wire.WireError:
            self._obs.inc("rejected_wire")
            return self._respond(_reject(self.spec, 0xFFFFFFFF))
        try:
            wire.check_frame_against_spec(h, self.spec, len(chunk))
        except wire.HeaderMismatchError:
            self._obs.inc("rejected_spec")
            return self._respond(_reject(self.spec, h.client_id,
                                         round_id=h.round_id))
        if _obs.tracing_enabled():
            _obs.tracer().event("chunk",
                                parent=("client", h.round_id, h.client_id),
                                round=h.round_id, client=h.client_id,
                                tier=self.node_id, chunk=h.chunk_index,
                                n_chunks=h.n_chunks)
        if h.client_id in self._gave_up:
            return self._respond(_reject(self.spec, h.client_id))
        if h.client_id in self._accepted:
            self._obs.inc("duplicates")
            return self._respond(self._ack(h.client_id))
        if h.client_id not in self._admitted:
            if self._sealed:
                self._obs.inc("retried")
                return self._respond(_retry(h.round_id, h.client_id,
                                            h.attempt, self._next_round_id))
            if (self.max_pending is not None
                    and self.occupancy >= self.max_pending):
                self._obs.inc("retried")
                return self._respond(_retry(h.round_id, h.client_id,
                                            h.attempt, self.spec.round_id))
            self._admitted.add(h.client_id)
        if h.n_chunks == 1:
            p = wire.payload_from_body(h, chunk)
        else:
            if h.attempt < self._attempt_floor.get(h.client_id, 0):
                # stale chunk of an attempt this tier already NACKed must
                # not re-open a dead reassembly stream
                self._obs.inc("duplicates")
                return self._respond(self._queued(h, slim=True))
            event, p = self._rx.add(h, chunk)
            if event == S.REJECT:
                self._obs.inc("resends_sent")
                return self._respond(wire.Response(
                    status=wire.STATUS_RESEND,
                    round_id=self.spec.round_id, client_id=h.client_id,
                    attempt_next=h.attempt, q_next=h.q,
                    y_next=wire.y_at_attempt(self.spec, h.attempt),
                    missing=tuple(range(h.n_chunks)),
                    credit=self.spec.window))
            if p is None:                   # PROGRESS / DUPLICATE / STALE
                if event in (S.DUPLICATE, S.STALE):
                    self._obs.inc("duplicates")
                return self._respond(self._queued(h, slim=True))
            if p.streamed:
                # stream complete + sealed: verify the incremental fold and
                # commit into R now (the tier's per-child drain)
                return self._finish_streamed(h, p)
        try:
            wire.check_sides_against_spec(p, self.spec)
        except wire.HeaderMismatchError:
            self._obs.inc("rejected_spec")
            return self._respond(_reject(self.spec, p.client_id))
        prev = self._pending.get(p.client_id)
        if prev is not None and prev.attempt >= p.attempt:
            self._obs.inc("duplicates")
        else:
            self._pending[p.client_id] = p
            self._obs.inc("queued")
            if _obs.tracing_enabled():
                _obs.tracer().event(
                    "seal", parent=("client", h.round_id, p.client_id),
                    round=h.round_id, client=p.client_id,
                    tier=self.node_id, attempt=p.attempt)
        return self._respond(self._queued(h))

    def drain_children(self) -> "list[bytes]":
        """Verify + fold every staged child payload; returns verdicts.

        The sum-without-decode core: per payload, residual-lift the packed
        colors about ``k0`` (integer-only), verify the §5 checksum over
        ``k0 + r`` in uint32 math, saturation-check the fold against the
        escalation cap's coordinate range, and add the residuals into the
        int64 accumulator.  No decode dispatch is issued — asserted via
        ``ops.DISPATCH_COUNTS`` in the tests.
        """
        if not self._pending:
            return self._resend_requests()
        self._obs.inc("drains")
        fold_sp = _obs.tracer().begin(
            "fold", parent=("round", self.spec.round_id),
            round=self.spec.round_id, tier=self.node_id,
            payloads=len(self._pending)) if _obs.tracing_enabled() else None
        staged = sorted(self._pending.values(), key=lambda p: p.client_id)
        self._pending.clear()
        responses = []
        for p in staged:
            words = torch.from_numpy(np.array(p.words, np.uint32)
                                     .view(np.int32)).to(self.device)
            r = K.lattice_residuals(words, self._k0, q=p.q)
            del words
            # h(k0 + r) over the int32 coordinates, mod 2^32
            chk = int(ED.coord_checksum(self._k0 + r, self._weights))
            if chk != (p.check & _M32):
                responses.append(self._decode_failure(p))
                continue
            cand = self._R + r
            del r
            if not self._within(cand, self._q_max):
                # folding this child would push the combined coordinates
                # outside the widest escalation attempt's centered range —
                # the repacked colors would alias.  Terminal for the child
                # at THIS tier (it may enroll flat in a later round).
                self._obs.inc("saturated")
                self._obs.inc("gave_up")
                self._gave_up.add(p.client_id)
                self._rx.discard(p.client_id)
                if fold_sp is not None:
                    _obs.tracer().event(
                        "saturation_reject", parent=fold_sp.span_id,
                        round=self.spec.round_id, tier=self.node_id,
                        client=p.client_id)
                _obs.trigger("saturation_reject", at=_obs.tracer().now(),
                             round=self.spec.round_id, tier=self.node_id,
                             client=p.client_id)
                responses.append(self._respond(_reject(self.spec,
                                                       p.client_id)))
                continue
            self._R = cand
            self._m += p.n_summed
            self._obs.inc("accepted")
            self._obs.inc("clients_summed", p.n_summed)
            self._accepted.add(p.client_id)
            self._rx.discard(p.client_id)
            responses.append(self._respond(self._ack(p.client_id)))
        if fold_sp is not None:
            _obs.tracer().end(fold_sp, folded=self._m)
        return responses + self._resend_requests()

    # ------------------------------------------------------- STREAMING RX
    def _fold_range(self, h: wire.FrameHeader, word_start: int,
                    words: np.ndarray) -> None:
        """``on_range_validated``: residual-lift one validated word range
        into the stream's speculative record (same integer identity the
        batched fold uses); the session frees the chunk bytes after this."""
        key = (h.client_id, h.attempt, h.payload_crc)
        rec = self._folds.get(key)
        if rec is None:
            rec = self._folds[key] = _StreamFold(self.spec.padded,
                                                 self.spec.nb, self.device)
        c0 = word_start * (32 // L.bits_for_q(h.q))
        w = torch.from_numpy(np.array(words, np.uint32).view(np.int32))
        r = K.lattice_residuals_range(w.to(self.device), self._k0, q=h.q,
                                      word_start=word_start)
        n = r.shape[0]
        rec.r[c0:c0 + n] = r.to(torch.int16)
        rec.coords += n
        part = int(ED.coord_checksum(r + self._k0[c0:c0 + n],
                                     self._weights[c0:c0 + n]))
        rec.check = (rec.check + part) & _M32

    def _drop_stream(self, h: wire.FrameHeader) -> None:
        """``on_stream_discarded``: drop the speculative record — nothing
        was committed to R, so this IS the rollback."""
        self._folds.pop((h.client_id, h.attempt, h.payload_crc), None)

    def _finish_streamed(self, h: wire.FrameHeader,
                         p: wire.Payload) -> bytes:
        """A child stream completed and its payload-CRC seal held: verify
        the incremental §5 checksum and the saturation guard (which needs
        the FULL residual vector — the record has it), then fold into R."""
        rec = self._folds.pop((h.client_id, h.attempt, h.payload_crc), None)
        try:
            wire.check_sides_against_spec(p, self.spec)
        except wire.HeaderMismatchError:
            self._obs.inc("rejected_spec")
            return self._respond(_reject(self.spec, p.client_id))
        if rec is None or rec.coords != self.spec.padded:
            self._obs.inc("resends_sent")
            return self._respond(wire.Response(
                status=wire.STATUS_RESEND, round_id=self.spec.round_id,
                client_id=h.client_id, attempt_next=h.attempt, q_next=h.q,
                y_next=wire.y_at_attempt(self.spec, h.attempt),
                missing=tuple(range(h.n_chunks)), credit=self.spec.window))
        if rec.check != (h.check & _M32):
            return self._decode_failure(p)
        cand = self._R + rec.r.to(torch.int64)
        if not self._within(cand, self._q_max):
            self._obs.inc("saturated")
            self._obs.inc("gave_up")
            self._gave_up.add(h.client_id)
            if _obs.tracing_enabled():
                _obs.tracer().event(
                    "saturation_reject",
                    parent=("round", self.spec.round_id),
                    round=self.spec.round_id, tier=self.node_id,
                    client=h.client_id)
            _obs.trigger("saturation_reject", at=_obs.tracer().now(),
                         round=self.spec.round_id, tier=self.node_id,
                         client=h.client_id)
            return self._respond(_reject(self.spec, h.client_id))
        self._R = cand
        self._m += h.n_summed
        self._obs.inc("accepted")
        self._obs.inc("clients_summed", h.n_summed)
        self._accepted.add(h.client_id)
        return self._respond(self._ack(h.client_id, ack=h.n_chunks))

    def _decode_failure(self, p: wire.Payload) -> bytes:
        """The flat server's escalation schedule, verbatim: NACK to the
        next attempt, terminal REJECT at the color-space cap."""
        self._obs.inc("decode_failures")
        nxt = p.attempt + 1
        if p.q >= wire.Q_CAP or nxt >= self.spec.max_attempts:
            self._gave_up.add(p.client_id)
            self._rx.discard(p.client_id)
            self._obs.inc("gave_up")
            return self._respond(_reject(self.spec, p.client_id))
        self._obs.inc("nacks_sent")
        self._attempt_floor[p.client_id] = nxt
        return self._respond(wire.Response(
            status=wire.STATUS_NACK, round_id=self.spec.round_id,
            client_id=p.client_id, attempt_next=nxt,
            q_next=wire.q_at_attempt(self.spec.cfg.q, nxt),
            y_next=wire.y_at_attempt(self.spec, nxt),
            y_buckets=self._margin_tuple(nxt), credit=self.spec.window))

    def _margin_tuple(self, attempt: int) -> tuple:
        t = self._margins.get(attempt)
        if t is None:
            t = tuple(float(v) for v in
                      wire.y_buckets_at_attempt(self.spec, attempt))
            self._margins[attempt] = t
        return t

    def _queued(self, h: wire.FrameHeader,
                slim: bool = False) -> wire.Response:
        return wire.Response(
            status=wire.STATUS_QUEUED, round_id=self.spec.round_id,
            client_id=h.client_id, attempt_next=h.attempt, q_next=h.q,
            y_next=wire.y_at_attempt(self.spec, h.attempt),
            y_buckets=() if slim else self._margin_tuple(h.attempt),
            ack=self._rx.high_water(h.client_id) if self.spec.window else 0,
            credit=self.spec.window)

    def _ack(self, client_id: int, ack: int = 0) -> wire.Response:
        return wire.Response(status=wire.STATUS_ACK,
                             round_id=self.spec.round_id,
                             client_id=client_id, attempt_next=0, q_next=0,
                             y_next=0.0, ack=ack, credit=self.spec.window)

    def _respond(self, r: wire.Response) -> bytes:
        out = wire.encode_response(r)
        self._obs.inc("bytes_out", len(out))
        return out

    def _resend_requests(self) -> "list[bytes]":
        out = []
        for cid, (attempt, missing) in self._rx.incomplete().items():
            self._obs.inc("resends_sent")
            out.append(self._respond(wire.Response(
                status=wire.STATUS_RESEND, round_id=self.spec.round_id,
                client_id=cid, attempt_next=attempt,
                q_next=wire.q_at_attempt(self.spec.cfg.q, attempt),
                y_next=wire.y_at_attempt(self.spec, attempt),
                y_buckets=self._margin_tuple(attempt), missing=missing,
                ack=self._rx.high_water(cid) if self.spec.window else 0,
                credit=self.spec.window)))
        return out

    # ----------------------------------------------------------- LIFECYCLE
    def seal(self, next_round_id: int = 0) -> None:
        """Stop admitting NEW children (cutover); admitted children keep
        full service.  Once every admitted child resolves, the next tick
        forwards the combined payload upstream."""
        self._sealed = True
        self._next_round_id = next_round_id

    @property
    def sealed(self) -> bool:
        return self._sealed

    @property
    def admitted_count(self) -> int:
        return len(self._admitted)

    @property
    def unresolved(self) -> frozenset:
        return frozenset(self._admitted - self._accepted - self._gave_up)

    @property
    def occupancy(self) -> int:
        return len(set(self._pending) | self._rx.open_clients())

    @property
    def accepted_clients(self) -> frozenset:
        return frozenset(self._accepted)

    @property
    def n_summed(self) -> int:
        """Clients folded into the accumulator so far."""
        return self._m

    def expire_client(self, client_id: int) -> None:
        """Drop an unresolved straggler's state without a verdict."""
        if (client_id not in self._admitted or client_id in self._accepted
                or client_id in self._gave_up):
            return
        self._pending.pop(client_id, None)
        self._rx.discard(client_id)
        self._admitted.discard(client_id)
        self._obs.inc("expired")

    @property
    def forwarded_q(self) -> "int | None":
        """Color space of the forwarded combined payload (None: not yet
        forwarded).  The root issues one batched decode per distinct value
        of this across its children."""
        if self._up_attempt is None:
            return None
        return wire.q_at_attempt(self.spec.cfg.q, self._up_attempt)

    @property
    def upstream_done(self) -> bool:
        """This tier needs nothing more from its parent: combined payload
        accepted, escalation exhausted, or nothing to forward at all."""
        if self._up_acked or self._up_gave_up:
            return True
        return self._sealed and not self.unresolved and self._m == 0

    # ------------------------------------------------------------ UPSTREAM
    @staticmethod
    def _within(R: torch.Tensor, q: int) -> bool:
        """Does every coordinate of R lie in [-q//2, q//2), the range
        centered_mod maps mod-q colors onto?"""
        lo, hi = torch.aminmax(R)
        half = q // 2
        return bool(hi < half) and bool(lo >= -half)

    def _fits(self, q: int) -> bool:
        """Would the accumulated R survive a round trip through mod-q
        colors?"""
        return self._within(self._R, q)

    def _forward_attempt(self) -> int:
        """Smallest escalation attempt whose color space holds R (exists by
        the saturation guard, which pinned |R| under q_max/2)."""
        for a in range(self.spec.max_attempts):
            if self._fits(wire.q_at_attempt(self.spec.cfg.q, a)):
                return a
        raise AssertionError("saturation guard violated: R exceeds q_max/2")

    def _frames_at(self, attempt: int) -> "list[bytes]":
        """The combined payload's chunk frames at an escalation level
        (cached: retransmits are byte-identical).  ``K' = k0 + R`` packs as
        mod-q' colors; the checksum is ``h(K')`` so the root's verification
        passes by construction; ``n_summed`` carries the fold count."""
        cached = self._up_frames.get(attempt)
        if cached is None:
            q = wire.q_at_attempt(self.spec.cfg.q, attempt)
            k_fwd = (self._k0.to(torch.int64) + self._R).to(torch.int32)
            words = K.lattice_pack_coords(k_fwd, q=q)
            # h(K') mod 2^32, the same bits as the reference's uint32 sum
            check = int(ED.coord_checksum(k_fwd, self._weights))
            del k_fwd
            words = words.cpu().numpy().view(np.uint32)
            cached = C.encode_chunks(self.spec, self.node_id, attempt, q,
                                     words, self._sides_np, check,
                                     n_summed=self._m)
            self._up_frames[attempt] = cached
        return list(cached)

    def _send_up(self, frames: "list[bytes]") -> "list[bytes]":
        self._obs.inc("up_frames_sent", len(frames))
        self._obs.inc("bytes_out", sum(len(f) for f in frames))
        return frames

    def _upstream_tick(self) -> "list[bytes]":
        """Forward once everything below is resolved; re-send the full
        sequence if the parent has stayed silent (total-loss recovery —
        a partially-received payload is chased by the parent's RESEND)."""
        if (not self._sealed or self.unresolved or self._m == 0
                or self._up_acked or self._up_gave_up):
            return []
        if not self._up_sent:
            self._up_sent = True
            self._up_attempt = self._forward_attempt()
            self._up_idle_ticks = 0
            return self._send_up(self._frames_at(self._up_attempt))
        self._up_idle_ticks += 1
        if self._up_idle_ticks >= _UP_RESEND_TICKS:
            self._up_idle_ticks = 0
            self._obs.inc("up_resends")
            return self._send_up(self._frames_at(self._up_attempt))
        return []

    def handle_upstream(self, data: bytes) -> "list[bytes]":
        """Process the parent's response; returns the frames to send next
        (the :class:`repro_torch.agg.client.AggClient` state machine,
        acting for the combined payload)."""
        try:
            r = wire.decode_response(data)
        except wire.WireError:
            return []
        if (r.client_id != self.node_id
                or r.round_id != self.spec.round_id):
            return []
        self._up_idle_ticks = 0
        if r.status in (wire.STATUS_ACK, wire.STATUS_QUEUED):
            self._up_acked = self._up_acked or r.status == wire.STATUS_ACK
            return []
        if r.status == wire.STATUS_RETRY:
            self.retry_round = r.q_next or None
            return []
        if r.status == wire.STATUS_REJECT:
            self._up_gave_up = True
            return []
        if self._up_acked or self._up_gave_up or self._up_attempt is None:
            return []
        if r.status == wire.STATUS_RESEND:
            if r.attempt_next != self._up_attempt:
                return []
            self._obs.inc("up_resends")
            return self._send_up(C.select(self._frames_at(self._up_attempt),
                                          r.missing))
        # NACK: escalate — repack the SAME coordinates at the directed q
        if r.attempt_next >= self.spec.max_attempts:
            self._up_gave_up = True
            return []
        if r.attempt_next <= self._up_attempt:
            return []
        self._obs.inc("up_escalations")
        self._up_attempt = r.attempt_next
        return self._send_up(self._frames_at(self._up_attempt))


# response client_id offset: magic 4s | version u16 | status u16 | round u32
_RESP_CID_OFF = 12


class AggTree:
    """A fanout^j tier tree behind one :class:`~repro_torch.agg.api.AggNode`.

    ``tiers`` tier layers sit between the clients and the root: the layer
    feeding the root has ``fanout`` tiers, the next one down
    ``fanout**2``, and so on; clients hash onto the leaf layer by
    ``client_id % n_leaf`` and every internal hop is ordinary transport.
    ``root`` defaults to a flat :class:`~repro_torch.agg.server.AggServer` and
    may be any AggNode-shaped server of the same round.

    ``loss`` (tests/bench): ``loss(src_id, dst_id, data) -> bytes | None``
    applied to every INTERNAL message (tier->parent frames and
    parent->tier responses); ``None`` drops the message.  Client-facing
    traffic is the driver's to mangle.
    """

    def __init__(self, spec: wire.RoundSpec, anchor, *, fanout: int = 8,
                 tiers: int = 1, max_pending: "int | None" = None,
                 root=None,
                 loss: "Optional[Callable]" = None, device=None):
        if fanout < 2:
            raise ValueError(f"fanout must be >= 2, got {fanout}")
        if tiers < 1:
            raise ValueError(f"tiers must be >= 1, got {tiers}")
        self.spec = spec
        self.fanout = fanout
        self.tiers = tiers
        self._loss = loss
        device = resolve_device(device)
        self.root = (root if root is not None
                     else AggServer(spec, anchor, max_pending=max_pending,
                                    device=device))
        # layers[0] feeds the root (fanout nodes), layers[-1] is the leaf
        # layer (fanout**tiers nodes) the clients talk to
        self.layers: "list[list[TierAggregator]]" = []
        self._by_node_id: "dict[int, TierAggregator]" = {}
        self._parent: "dict[int, object]" = {}      # node_id -> parent node
        for depth in range(tiers):
            n = fanout ** (depth + 1)
            layer = []
            for i in range(n):
                nid = TIER_ID_BASE | (depth << 20) | i
                t = TierAggregator(spec, anchor, nid,
                                   max_pending=max_pending, device=device)
                layer.append(t)
                self._by_node_id[nid] = t
                self._parent[nid] = (self.root if depth == 0
                                     else self.layers[depth - 1][i // fanout])
            self.layers.append(layer)
        self._leaf = self.layers[-1]
        self._sealing = False

    # ------------------------------------------------------------ ROUTING
    def _leaf_for(self, client_id: int) -> TierAggregator:
        return self._leaf[client_id % len(self._leaf)]

    def _route(self, src, msg: bytes):
        """None = external (a real client's response); else the internal
        destination node."""
        if msg[:4] == wire.MAGIC_PAYLOAD:
            # only tiers emit frames; they go to that tier's parent
            return self._parent[src.node_id]
        if len(msg) >= _RESP_CID_OFF + 4:
            cid = int.from_bytes(msg[_RESP_CID_OFF:_RESP_CID_OFF + 4],
                                 "little")
            return self._by_node_id.get(cid)
        return None

    def _deliver(self, src, dest, msg: bytes, now: float):
        if self._loss is not None:
            src_id = getattr(src, "node_id", 0)
            dst_id = getattr(dest, "node_id", 0)
            msg = self._loss(src_id, dst_id, msg)
            if msg is None:
                return []
        return [(dest, r) for r in dest.ingest_frame(msg, now)]

    # ------------------------------------------------------------ AggNode
    def ingest_frame(self, data: bytes, now: float = 0.0) -> "list[bytes]":
        """Route one client frame to its edge tier; returns the tier's
        response (the client's QUEUED/ACK/RESEND/... — edge tiers answer
        clients directly, the root never sees individual client traffic)."""
        peek = wire.peek_route(data)
        leaf = self._leaf_for(peek[1]) if peek else self._leaf[0]
        return [leaf.ingest_child(data)]

    def tick(self, now: float = 0.0) -> "list[bytes]":
        """Fire every node's policy and pump internal traffic until
        quiescent; returns only the EXTERNAL messages (client verdicts and
        chunk RESENDs), deduplicated within the call — one tick emits each
        distinct external message once, the flat server's cadence.

        Layer-synchronized sealing keeps the root's intake a single wave
        (all tiers of a layer forward in the same pump iteration), so a
        loss-free round costs exactly one root drain — one batched decode
        dispatch per color space."""
        self._advance_seal()
        out: "list[bytes]" = []
        seen: "set[bytes]" = set()
        msgs = []
        for node in self._all_nodes():
            msgs.extend((node, m) for m in node.tick(now))
        for _ in range(_MAX_PUMP):
            internal = []
            routed_any = False
            for src, m in msgs:
                dest = self._route(src, m)
                if dest is None:
                    if m not in seen:
                        seen.add(m)
                        out.append(m)
                    continue
                routed_any = True
                internal.extend(self._deliver(src, dest, m, now))
            if not routed_any:
                break
            self._advance_seal()
            # re-fire every node's policy after the delivery wave: drains
            # fold the new payloads, newly-sealed layers forward, verdicts
            # flow back down
            msgs = internal
            for node in self._all_nodes():
                msgs.extend((node, m) for m in node.tick(now))
        return out

    def published(self) -> "list[PublishedRound]":
        """The root's outcome with ``accepted`` mapped from tier node ids
        back to the real client ids their chains folded in."""
        prs = self.root.published()
        return [dataclasses.replace(pr,
                                    accepted=self._map_accepted(pr.accepted))
                for pr in prs]

    # ----------------------------------------------------------- LIFECYCLE
    def seal(self, next_round_id: int = 0) -> None:
        """Cut the round over: leaf tiers stop admitting new clients now;
        each internal layer (and finally the root) seals automatically once
        everything below it has forwarded — so a tier is never refused
        admission by its own parent."""
        self._next_round_id = next_round_id
        self._sealing = True
        for t in self._leaf:
            t.seal(next_round_id)

    def _advance_seal(self) -> None:
        if not self._sealing:
            return
        # layer barrier: a layer seals only when the WHOLE layer below is
        # done with its upstream — so all of a layer's tiers forward in the
        # same pump iteration and the parent (ultimately the root) folds
        # their payloads in a single drain wave
        for depth in range(self.tiers - 2, -1, -1):      # above-leaf layers
            below = self.layers[depth + 1]
            if all(k.upstream_done for k in below):
                for t in self.layers[depth]:
                    if not t.sealed:
                        t.seal(self._next_round_id)
        if (not self.root_sealed
                and all(t.upstream_done for t in self.layers[0])):
            self.root.seal(self._next_round_id)

    @property
    def root_sealed(self) -> bool:
        return bool(getattr(self.root, "sealed", False))

    @property
    def accepted_clients(self) -> frozenset:
        """Real client ids in the (to-be-)published mean: a client counts
        iff its edge tier accepted it AND every combined payload on its
        path to the root was accepted."""
        accepted = getattr(self.root, "accepted_clients", frozenset())
        return self._map_accepted(accepted)

    def _map_accepted(self, accepted: frozenset) -> frozenset:
        out: set = set()
        for cid in accepted:
            tier = self._by_node_id.get(cid)
            if tier is None:
                out.add(cid)                 # a real client at the root
                continue
            out |= self._tier_clients(tier)
        return frozenset(out)

    def _tier_clients(self, tier: TierAggregator) -> set:
        out: set = set()
        for cid in tier.accepted_clients:
            child = self._by_node_id.get(cid)
            if child is None:
                out.add(cid)
            else:
                out |= self._tier_clients(child)
        return out

    def _all_nodes(self):
        """Leaf -> top -> root: children act before their parents so one
        tick moves data a full level upward."""
        for layer in reversed(self.layers):
            yield from layer
        yield self.root

    # ---------------------------------------------------------- TELEMETRY
    @property
    def root_ingress_payloads(self) -> int:
        """Complete payloads the root has staged+folded — the acceptance
        bound is <= fanout (one combined payload per top tier)."""
        st = getattr(self.root, "stats", None)
        return (st.queued if st is not None else 0)

    def tier_stats(self) -> "list[TierStats]":
        return [t.stats for layer in self.layers for t in layer]
