"""Server side: streaming integer-space accumulator + batched drain;
counterpart of ``repro.agg.server``.

Arrival path (:meth:`AggServer.receive`): parse and validate one transport
frame (framing errors and spec mismatches are counted and REJECTed), dedupe
by client id, and route it by its chunk coordinates — a single-frame
payload is staged directly, a chunk goes through the reassembly session
layer.  The server stages the *packed words* until a drain.

**Streaming drain** (``RoundSpec.window > 0``): validated contiguous word
ranges are residual-folded on arrival about the round's decode-reference
coordinates ``k0`` into a speculative per-stream record (int16 residuals,
an incrementally accumulated §5 checksum, per-bucket distance telemetry),
committed only when the stream completes and its checksum verifies; the
published mean stays bit-identical to the sealed drain.

**Sealed drain** (:meth:`AggServer.drain`): all pending payloads of one
color space q are decoded against the server's decode reference in ONE
batched kernel launch (:func:`repro_torch.kernels.ops.
lattice_decode_batched`, per-sender per-bucket sides, so no (S, n) side
array is built), their checksums verified, and the accepted senders'
integer coordinates summed into the round accumulator.  Integer addition
is exact and commutative, so the mean is bit-identical under any arrival
order and any drain batching.  Unlike the reference, the drain does not pad
the sender axis to a block multiple (that served a compile cache; padded
rows never entered the sum).  The drain's epilogue (checksums, masked
integer sum, max |k|, distance telemetry) runs over column chunks of the
(S, n) coordinates so that its temporaries stay bounded beside them.

Anchored rounds decode in anchor-relative space (reference 0) and add the
anchor back at finalize.  Decode failures (checksum mismatch) are NACKed
with the next escalation level, or REJECTed at the q cap / attempt limit.
Finalize: mean = ((ksum / count) + u) * s_b (+ anchor), unbucketized, on
the server's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

import repro_torch.obs as _obs
from repro_torch import resolve_device
from repro_torch.agg import rounds
from repro_torch.agg.api import PublishedRound
from repro_torch.agg.transport import frame as wire
from repro_torch.agg.transport import session as S
from repro_torch.core import lattice as L
from repro_torch.kernels import ops as K

_M32 = 0xFFFFFFFF
# elements of the (S, n) coordinates the drain epilogue handles at once:
# its int64 temporaries stay around a GB whatever S and n are
_EPILOGUE_ELEMS = 1 << 26


@dataclasses.dataclass
class RoundStats:
    """Per-round service telemetry."""
    received: int = 0
    queued: int = 0
    accepted: int = 0
    duplicates: int = 0
    rejected_wire: int = 0       # framing: truncated / corrupt / bad version
    rejected_spec: int = 0       # well-formed but wrong round/config/anchor
    decode_failures: int = 0     # §5 checksum detections across all drains
    nacks_sent: int = 0
    resends_sent: int = 0        # chunk-level RESEND responses
    retried: int = 0             # non-terminal RETRY responses
    expired: int = 0             # admitted clients dropped by a deadline
    gave_up: int = 0             # clients dropped after escalation exhausted
    drains: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    peak_unvalidated_bytes: int = 0   # largest frame staged before its CRC
    peak_pending_store_bytes: int = 0  # staged bodies + reassembly bytes
    max_dist: float = 0.0        # max |decoded - ref|_inf over accepts
    dist_b: Optional[np.ndarray] = None    # (nb,) per-bucket max distance
    fails_b: Optional[np.ndarray] = None   # (nb,) per-bucket failure counts


def _reject(spec: wire.RoundSpec, client_id: int,
            round_id: "int | None" = None) -> wire.Response:
    """``round_id`` defaults to the server's round; spec-mismatch rejects
    echo the offending frame's round instead."""
    return wire.Response(status=wire.STATUS_REJECT,
                         round_id=spec.round_id if round_id is None
                         else round_id,
                         client_id=client_id, attempt_next=0, q_next=0,
                         y_next=0.0)


def _retry(round_id: int, client_id: int, attempt: int,
           open_round_id: int) -> wire.Response:
    """The non-terminal admission verdict (round sealed to new clients or
    pending store full); ``q_next`` names the round open for admission."""
    return wire.Response(status=wire.STATUS_RETRY, round_id=round_id,
                         client_id=client_id, attempt_next=attempt,
                         q_next=open_round_id, y_next=0.0)


class _StreamFold:
    """Speculative per-stream fold for the streaming drain: int16 residuals
    (|r| <= q/2 <= 2^15), the incrementally accumulated §5 checksum (h(k)
    is linear, so per-range partial sums compose mod 2^32) and per-bucket
    distance telemetry, on the server's device.  Nothing here has touched
    the round accumulator — dropping the record IS the rollback."""
    __slots__ = ("r", "check", "dist_b", "coords")

    def __init__(self, padded: int, nb: int, device: torch.device):
        self.r = torch.zeros((padded,), dtype=torch.int16, device=device)
        self.check = 0          # the uint32 value, carried as a python int
        self.dist_b = torch.zeros((nb,), dtype=torch.float32, device=device)
        self.coords = 0


def _epilogue_cols(senders: int, bucket: int) -> int:
    """Columns per epilogue chunk: a whole number of buckets, about
    ``_EPILOGUE_ELEMS`` coordinates across all senders."""
    per_sender = max(1, _EPILOGUE_ELEMS // max(1, senders))
    return max(1, per_sender // bucket) * bucket


def _drain_math(words: torch.Tensor, sides: torch.Tensor,
                checks: torch.Tensor, anchor: torch.Tensor, u: torch.Tensor,
                weights: torch.Tensor, y_col: torch.Tensor, m: torch.Tensor,
                k0: torch.Tensor, *, q: int, bucket: int):
    """Decode S payloads, verify checksums, sum accepted integer coords.

    words: (S, nw) int32 bit view; sides: (S, nb) f32 sidecars; checks: (S,)
    int64 uint32 values; anchor/u/weights/k0: (n,) (the decode reference,
    dither, checksum weights and reference coordinates); y_col: (nb,)
    decode margins at this q; m: (S,) int32 n_summed of each payload.

    A combined payload from a tree tier (m > 1) carries ``k0 + sum_i r_i``,
    so its true integer sum is ``K' + (m-1) * k0``; for m == 1 the
    correction is zero.

    Returns (ok (S,) bool, ksum_delta (n,) int32, count_delta int,
    max_dist f32 tensor, dist_b (nb,), fails_b (nb,), max_abs_k int).  The
    distance telemetry is masked to unit payloads (m == 1).

    One batched decode launch; then two passes over column chunks of the
    (S, n) coords: the first takes the checksums, max |k_eff| and the
    per-bucket distances, the second (once ``ok`` is known) the masked
    integer sum.
    """
    k = K.lattice_decode_batched(words, anchor, u, sides, q=q,
                                 mode="coords", bucket=bucket)  # (S, n)
    senders, n = k.shape
    nb = n // bucket
    dev = k.device
    cols = _epilogue_cols(senders, bucket)
    mm1 = (m.to(torch.int32) - 1)[:, None]
    check = torch.zeros(senders, dtype=torch.int64, device=dev)
    max_abs = torch.zeros(senders, dtype=torch.int32, device=dev)
    dist_bk = torch.empty((senders, nb), dtype=torch.float32, device=dev)
    for c0 in range(0, n, cols):
        c1 = min(n, c0 + cols)
        kc = k[:, c0:c1]
        wc = weights[c0:c1].to(torch.int64) & _M32
        check += ((kc.to(torch.int64) * wc) & _M32).sum(dim=1)
        k_eff = kc + mm1 * k0[None, c0:c1]
        max_abs = torch.maximum(max_abs, k_eff.abs().amax(dim=1))
        b0, b1 = c0 // bucket, c1 // bucket
        t = (kc.to(torch.float32) + u[None, c0:c1]).reshape(
            senders, b1 - b0, bucket)
        # |(k + u) * s - anchor|, the mul-sub rounded once as the
        # reference's compiled drain rounds it
        dist_bk[:, b0:b1] = L.fma_f32_abs_amax(
            t, sides[:, b0:b1, None],
            -anchor[c0:c1].reshape(1, b1 - b0, bucket))
    ok = (check & _M32) == checks
    ksum_delta = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.nonzero(ok).flatten()
    if idx.numel():
        for c0 in range(0, n, cols):
            c1 = min(n, c0 + cols)
            k_eff = k[idx, c0:c1] + mm1[idx] * k0[None, c0:c1]
            ksum_delta[c0:c1] = k_eff.sum(dim=0, dtype=torch.int32)
    del k
    count_delta = int(torch.where(ok, m, 0).sum())
    max_abs_k = int(torch.where(ok, max_abs, 0).max())
    unit = ok & (m == 1)
    unit_dist = torch.where(unit[:, None], dist_bk, 0.0)
    max_dist = unit_dist.max()
    dist_b = unit_dist.amax(dim=0)
    # failure attribution: for checksum-failed unit senders, buckets whose
    # decoded distance exceeds the margin carry the blame
    failed = ~ok & (m == 1)
    over = dist_bk > 1.5 * y_col[None]
    fails_b = torch.where(failed[:, None] & over, 1.0, 0.0).sum(dim=0)
    return (ok, ksum_delta, count_delta, max_dist, dist_b, fails_b,
            max_abs_k)


def _mean_math(ksum: torch.Tensor, count: int, u: torch.Tensor,
               s_col: torch.Tensor) -> torch.Tensor:
    """(nb, bucket) integer sum -> round mean in bucket space: one IEEE
    division by the count, add the dither, scale by the sides."""
    c = torch.tensor(count, dtype=torch.float32, device=ksum.device)
    return (ksum.to(torch.float32) / c + u) * s_col


class AggServer:
    """One aggregation round's coordinator.

    ``anchor`` (numpy or tensor, (d,)) doubles as the decode reference and,
    in anchored rounds, the round anchor itself (validated against
    ``spec.anchor_digest``).  The round's state lives on ``device`` — the
    CUDA device unless the caller names another."""

    def __init__(self, spec: wire.RoundSpec, anchor,
                 max_pending: "int | None" = None,
                 streaming: "bool | None" = None, device=None):
        """``max_pending``: admission cap on distinct un-drained clients
        holding buffered state (a NEW client past it draws a non-terminal
        RETRY); ``None`` = unbounded.  ``streaming``: enable the streaming
        drain for multi-chunk payloads; ``None`` resolves to
        ``spec.window > 0``."""
        if tuple(np.shape(anchor)) != (spec.d,):
            raise ValueError(
                f"anchor has shape {tuple(np.shape(anchor))}, "
                f"spec.d={spec.d}")
        rounds.check_anchor(spec, anchor if spec.anchored else None)
        self.spec = spec
        self.device = dev = resolve_device(device)
        self.max_pending = max_pending
        self._sealed = False
        self._next_round_id = 0     # admission hint for RETRY after seal
        self._admitted: set[int] = set()
        anchor_t = torch.as_tensor(anchor).to(device=dev,
                                              dtype=torch.float32)
        self._anchor_b = rounds.bucketize(anchor_t, spec)
        if spec.anchored:
            # clients encoded x - anchor: decode in anchor-relative space
            # (reference 0), add the anchor back at finalize
            self._ref_flat = torch.zeros((spec.padded,), dtype=torch.float32,
                                         device=dev)
        else:
            self._ref_flat = self._anchor_b.reshape(-1)
        self._u = rounds.dither(spec, dev)                     # (nb, bucket)
        self._weights = rounds.checksum_weights(spec, dev)     # (padded,)
        self._sides = rounds.sides(spec, dev)                  # (nb,)
        # the decode's reference coordinates (padded,) int32
        self._k0 = rounds.decode_ref_coords(
            spec, None if spec.anchored else anchor_t, dev)
        self._anchor_t = anchor_t
        self._published: list[PublishedRound] = []
        self._pending: dict[int, wire.Payload] = {}
        self._pending_bytes = 0   # bodies staged for the batched drain
        self._folds: "dict[tuple, _StreamFold]" = {}
        self._ksum_st: "Optional[torch.Tensor]" = None  # (padded,) int64
        self._streaming = ((spec.window > 0) if streaming is None
                           else bool(streaming)) and spec.mtu > 0
        if self._streaming:
            self._rx = S.Reassembler(spec,
                                     on_range_validated=self._fold_range,
                                     on_stream_discarded=self._drop_stream)
        else:
            self._rx = S.Reassembler(spec)  # chunked-payload session layer
        self._accepted: set[int] = set()
        self._gave_up: set[int] = set()
        # per-client minimum live attempt (bumped by every NACK)
        self._attempt_floor: dict[int, int] = {}
        self._ksum = torch.zeros((spec.nb, spec.cfg.bucket),
                                 dtype=torch.int32, device=dev)
        self._count = 0
        self._max_abs_k = 0
        self._margins: dict[int, tuple] = {}
        self._obs = _obs.scope("agg_round", round=spec.round_id)
        self._stats = RoundStats(dist_b=np.zeros((spec.nb,), np.float32),
                                 fails_b=np.zeros((spec.nb,), np.float32))
        self._publish_traced = False

    @property
    def stats(self) -> RoundStats:
        """Per-round telemetry, materialized from the obs scope."""
        self._obs.fill(self._stats)
        return self._stats

    def _margin_tuple(self, attempt: int) -> tuple:
        t = self._margins.get(attempt)
        if t is None:
            t = tuple(float(v) for v in
                      wire.y_buckets_at_attempt(self.spec, attempt))
            self._margins[attempt] = t
        return t

    # ------------------------------------------------------------------ RX
    def receive(self, data: bytes) -> bytes:
        """Handle one arriving frame; returns the response bytes."""
        self._obs.inc("received")
        self._obs.inc("bytes_in", len(data))
        self._obs.set_max("peak_unvalidated_bytes", len(data))
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
                                chunk=h.chunk_index, n_chunks=h.n_chunks)
        if h.client_id in self._gave_up:
            return self._respond(_reject(self.spec, h.client_id))
        if h.client_id in self._accepted:
            # duplicate delivery of an already-accumulated client: ACK
            # idempotently, never double-count
            self._obs.inc("duplicates")
            return self._respond(self._ack(
                h.client_id, ack=h.n_chunks if self.spec.window else 0))
        if h.client_id not in self._admitted:
            # intake gate, before any buffered state exists for the client
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
                # stale chunk of an attempt this server already NACKed
                self._obs.inc("duplicates")
                return self._respond(self._queued(h, slim=True))
            event, p = self._rx.add(h, chunk)
            if event == S.REJECT:
                # the reassembled body failed its payload-CRC seal: drop
                # the stream, direct a full rebuild (non-terminal)
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
                self._note_pending_store()
                return self._respond(self._queued(h, slim=True))
            if p.streamed:
                # stream complete + payload-CRC sealed: verify and commit
                # the speculative fold now
                out = self._respond(self._finish_streamed(h, p))
                self._note_pending_store()
                return out
        try:
            wire.check_sides_against_spec(p, self.spec)
        except wire.HeaderMismatchError:
            self._obs.inc("rejected_spec")
            return self._respond(_reject(self.spec, p.client_id))
        prev = self._pending.get(p.client_id)
        if prev is not None and prev.attempt >= p.attempt:
            self._obs.inc("duplicates")
        else:
            if prev is not None:
                self._pending_bytes -= prev.words.nbytes + prev.sides.nbytes
            self._pending[p.client_id] = p
            self._pending_bytes += p.words.nbytes + p.sides.nbytes
            self._note_pending_store()
            self._obs.inc("queued")
            if _obs.tracing_enabled():
                _obs.tracer().event(
                    "seal", parent=("client", h.round_id, p.client_id),
                    round=h.round_id, client=p.client_id, attempt=p.attempt)
        return self._respond(self._queued(h))

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

    # -------------------------------------------------------- STREAMING RX
    def _note_pending_store(self) -> None:
        """The pending-store byte gauge: staged drain bodies + everything
        the reassembly layer is holding."""
        self._obs.set_max("peak_pending_store_bytes",
                          self._pending_bytes + self._rx.stats.buffer_bytes)

    def _fold_range(self, h: wire.FrameHeader, word_start: int,
                    words: np.ndarray) -> None:
        """``on_range_validated``: residual-fold one contiguous validated
        word range into the stream's speculative record; the session frees
        the chunk bytes as soon as this returns."""
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
        k = r.to(torch.int64) + self._k0[c0:c0 + n]
        wts = self._weights[c0:c0 + n].to(torch.int64) & _M32
        part = int(((k * wts) & _M32).sum()) & _M32
        rec.check = (rec.check + part) & _M32
        if h.n_summed == 1:
            # distance telemetry, masked to unit payloads like _drain_math
            b = self.spec.cfg.bucket
            bidx = torch.arange(c0, c0 + n, device=self.device) // b
            t = k.to(torch.float32) + self._u.reshape(-1)[c0:c0 + n]
            dist = L.fma_f32(t, self._sides[bidx],
                             -self._ref_flat[c0:c0 + n]).abs()
            rec.dist_b.scatter_reduce_(0, bidx, dist, reduce="amax")

    def _drop_stream(self, h: wire.FrameHeader) -> None:
        """``on_stream_discarded``: the rollback — drop the record."""
        self._folds.pop((h.client_id, h.attempt, h.payload_crc), None)

    def _finish_streamed(self, h: wire.FrameHeader,
                         p: wire.Payload) -> wire.Response:
        """A stream completed and its payload-CRC seal held: verify the
        fold's §5 checksum and commit."""
        rec = self._folds.pop((h.client_id, h.attempt, h.payload_crc), None)
        try:
            wire.check_sides_against_spec(p, self.spec)
        except wire.HeaderMismatchError:
            self._obs.inc("rejected_spec")
            return _reject(self.spec, p.client_id)
        if rec is None or rec.coords != self.spec.padded:
            # a fold record that never materialized: direct a full rebuild
            self._obs.inc("resends_sent")
            return wire.Response(
                status=wire.STATUS_RESEND, round_id=self.spec.round_id,
                client_id=h.client_id, attempt_next=h.attempt, q_next=h.q,
                y_next=wire.y_at_attempt(self.spec, h.attempt),
                missing=tuple(range(h.n_chunks)), credit=self.spec.window)
        if _obs.tracing_enabled():
            _obs.tracer().event(
                "seal", parent=("client", h.round_id, h.client_id),
                round=h.round_id, client=h.client_id, attempt=h.attempt)
        if rec.check != (h.check & _M32):
            return self._nack_streamed(h, rec)
        m = h.n_summed
        k_eff = rec.r.to(torch.int64) + m * self._k0.to(torch.int64)
        self._max_abs_k = max(self._max_abs_k, int(k_eff.abs().max()))
        if (self._count + m) * self._max_abs_k >= 2 ** 31:
            raise OverflowError(
                f"round {self.spec.round_id}: accumulating a streamed "
                f"sender with |coords| up to {self._max_abs_k} can "
                f"overflow the int32 sum ({self._count} accepted so far); "
                f"anchor the round (RoundSpec.anchor_digest) so "
                f"coordinates stay ~y/s instead of ~|x|/s")
        if self._ksum_st is None:
            self._ksum_st = torch.zeros((self.spec.padded,),
                                        dtype=torch.int64, device=self.device)
        self._ksum_st += k_eff
        self._count += m
        self._obs.inc("queued")
        self._obs.inc("accepted")
        if m == 1:
            dist_b = rec.dist_b.cpu().numpy()
            self._obs.set_max("max_dist", float(dist_b.max()))
            self._stats.dist_b = np.maximum(self._stats.dist_b, dist_b)
        self._accepted.add(h.client_id)
        return self._ack(h.client_id, ack=h.n_chunks)

    def _nack_streamed(self, h: wire.FrameHeader,
                       rec: _StreamFold) -> wire.Response:
        """§5 checksum mismatch on a completed stream: the same escalation
        verdict the batched drain would have produced."""
        self._obs.inc("decode_failures")
        if h.n_summed == 1:
            y_col = np.asarray(wire.y_buckets_at_attempt(self.spec,
                                                         h.attempt))
            self._stats.fails_b = self._stats.fails_b + \
                (rec.dist_b.cpu().numpy() > 1.5 * y_col).astype(np.float32)
        nxt = h.attempt + 1
        if h.q >= wire.Q_CAP or nxt >= self.spec.max_attempts:
            self._gave_up.add(h.client_id)
            self._obs.inc("gave_up")
            return _reject(self.spec, h.client_id)
        self._obs.inc("nacks_sent")
        self._attempt_floor[h.client_id] = nxt
        return wire.Response(
            status=wire.STATUS_NACK, round_id=self.spec.round_id,
            client_id=h.client_id, attempt_next=nxt,
            q_next=wire.q_at_attempt(self.spec.cfg.q, nxt),
            y_next=wire.y_at_attempt(self.spec, nxt),
            y_buckets=self._margin_tuple(nxt), credit=self.spec.window)

    # ------------------------------------------------------------ AggNode
    def ingest_frame(self, data: bytes, now: float = 0.0) -> "list[bytes]":
        """AggNode verb: one frame in, its response out."""
        return [self.receive(data)]

    def tick(self, now: float = 0.0) -> "list[bytes]":
        """AggNode verb: drain pending payloads + chunk-level RESENDs."""
        return self.drain()

    def published(self) -> "list[PublishedRound]":
        """AggNode verb: the round's outcome once it is sealed and every
        admitted client is resolved (finalized lazily, then cached)."""
        if self._published:
            return list(self._published)
        if not self._sealed or self.unresolved:
            return []
        mean, stats = self.finalize()
        self._published.append(PublishedRound(
            round_id=self.spec.round_id, spec=self.spec,
            # copied here, the one reader: the published anchor never
            # aliases the caller's array or tensor (the service and the
            # engine publish through Round and never pay for the copy)
            anchor=self._anchor_t.clone() if self.spec.anchored else None,
            mean=mean, stats=stats, accepted=self.accepted_clients,
            opened_at=0.0, sealed_at=0.0, published_at=0.0,
            anchor_round=0, staleness=0.0))
        return list(self._published)

    # ----------------------------------------------------------- LIFECYCLE
    def seal(self, next_round_id: int = 0) -> None:
        """Stop admitting NEW clients (round cutover); already-admitted
        clients keep full service.  Idempotent."""
        self._sealed = True
        self._next_round_id = next_round_id

    @property
    def sealed(self) -> bool:
        return self._sealed

    @property
    def admitted_count(self) -> int:
        """Distinct clients admitted into the round (quorum input)."""
        return len(self._admitted)

    @property
    def unresolved(self) -> frozenset:
        """Admitted clients with no outcome yet — empty means drained."""
        return frozenset(self._admitted - self._accepted - self._gave_up)

    @property
    def occupancy(self) -> int:
        """Distinct clients currently holding buffered server state."""
        return len(set(self._pending) | self._rx.open_clients())

    def expire_client(self, client_id: int) -> None:
        """Drop a straggler's state without a verdict (engine deadline)."""
        if (client_id not in self._admitted or client_id in self._accepted
                or client_id in self._gave_up):
            return                  # only unresolved stragglers expire
        prev = self._pending.pop(client_id, None)
        if prev is not None:
            self._pending_bytes -= prev.words.nbytes + prev.sides.nbytes
        self._rx.discard(client_id)   # fires the stream-fold rollback too
        self._admitted.discard(client_id)
        self._obs.inc("expired")
        if _obs.tracing_enabled():
            _obs.tracer().event("expire",
                                parent=("round", self.spec.round_id),
                                round=self.spec.round_id, client=client_id)

    # --------------------------------------------------------------- DRAIN
    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def transport_stats(self) -> S.ReassemblyStats:
        """The session layer's reassembly telemetry (chunked rounds)."""
        return self._rx.stats

    @property
    def accepted_clients(self) -> frozenset:
        return frozenset(self._accepted)

    def drain(self) -> list[bytes]:
        """Decode everything pending; returns ACK/NACK/REJECT responses.

        One batched kernel launch per distinct color space q among the
        pending payloads (a round at a single escalation level drains in
        exactly one launch)."""
        if not self._pending:
            return self._resend_requests()
        self._obs.inc("drains")
        drain_sp = _obs.tracer().begin(
            "drain", parent=("round", self.spec.round_id),
            round=self.spec.round_id, payloads=len(self._pending)) \
            if _obs.tracing_enabled() else None
        by_q: dict[int, list[wire.Payload]] = {}
        for p in self._pending.values():
            by_q.setdefault(p.q, []).append(p)
        self._pending.clear()
        self._pending_bytes = 0
        responses = []
        dev = self.device
        for q, plist in sorted(by_q.items()):
            plist.sort(key=lambda p: p.client_id)
            attempt0 = plist[0].attempt
            words = torch.from_numpy(
                np.stack([p.words for p in plist]).view(np.int32)).to(dev)
            sides = torch.from_numpy(
                np.stack([p.sides for p in plist])).to(dev)
            checks = torch.tensor([p.check & _M32 for p in plist],
                                  dtype=torch.int64, device=dev)
            m = torch.tensor([p.n_summed for p in plist], dtype=torch.int32,
                             device=dev)
            y_col = torch.from_numpy(
                wire.y_buckets_at_attempt(self.spec, attempt0)).to(dev)
            (ok, ksum_delta, n_clients, max_dist, dist_b, fails_b,
             max_abs_k) = \
                _drain_math(words, sides, checks, self._ref_flat,
                            self._u.reshape(-1), self._weights, y_col, m,
                            self._k0, q=q, bucket=self.spec.cfg.bucket)
            del words
            ok = ok.cpu().numpy()
            n_ok = int(ok.sum())
            # int32 accumulator guard: sum_i |k_i| <= count * max|k| must
            # stay below 2^31 or the exact integer sum may have wrapped
            self._max_abs_k = max(self._max_abs_k, max_abs_k)
            if (self._count + n_clients) * self._max_abs_k >= 2 ** 31:
                raise OverflowError(
                    f"round {self.spec.round_id}: accumulating {n_ok} more "
                    f"senders with |coords| up to {self._max_abs_k} can "
                    f"overflow the int32 sum ({self._count} accepted so "
                    f"far); anchor the round (RoundSpec.anchor_digest) so "
                    f"coordinates stay ~y/s instead of ~|x|/s")
            # in place: the accumulator is the size of the vector
            self._ksum += ksum_delta.reshape(self._ksum.shape)
            self._count += n_clients
            self._obs.inc("accepted", n_ok)
            self._obs.set_max("max_dist", float(max_dist))
            self._stats.dist_b = np.maximum(self._stats.dist_b,
                                            dist_b.cpu().numpy())
            self._stats.fails_b = self._stats.fails_b + \
                fails_b.cpu().numpy()
            for p, good in zip(plist, ok):
                if good:
                    self._accepted.add(p.client_id)
                    self._rx.discard(p.client_id)   # stale chunk sessions
                    responses.append(self._respond(self._ack(p.client_id)))
                    continue
                self._obs.inc("decode_failures")
                nxt = p.attempt + 1
                if p.q >= wire.Q_CAP or nxt >= self.spec.max_attempts:
                    self._gave_up.add(p.client_id)
                    self._rx.discard(p.client_id)
                    self._obs.inc("gave_up")
                    responses.append(
                        self._respond(_reject(self.spec, p.client_id)))
                    continue
                self._obs.inc("nacks_sent")
                self._attempt_floor[p.client_id] = nxt
                responses.append(self._respond(wire.Response(
                    status=wire.STATUS_NACK, round_id=self.spec.round_id,
                    client_id=p.client_id, attempt_next=nxt,
                    q_next=wire.q_at_attempt(self.spec.cfg.q, nxt),
                    y_next=wire.y_at_attempt(self.spec, nxt),
                    y_buckets=self._margin_tuple(nxt),
                    credit=self.spec.window)))
        if drain_sp is not None:
            _obs.tracer().end(drain_sp, accepted=len(self._accepted))
        return responses + self._resend_requests()

    def _resend_for(self, cid: int, attempt: int, missing: tuple) -> bytes:
        self._obs.inc("resends_sent")
        if _obs.metrics_enabled():
            _obs.counter("chunk_retransmits",
                         round=self.spec.round_id).inc(len(missing))
        return self._respond(wire.Response(
            status=wire.STATUS_RESEND, round_id=self.spec.round_id,
            client_id=cid, attempt_next=attempt,
            q_next=wire.q_at_attempt(self.spec.cfg.q, attempt),
            y_next=wire.y_at_attempt(self.spec, attempt),
            y_buckets=self._margin_tuple(attempt), missing=missing,
            ack=self._rx.high_water(cid) if self.spec.window else 0,
            credit=self.spec.window))

    def _resend_requests(self) -> list[bytes]:
        """Chunk-level NACKs for every still-incomplete reassembly."""
        return [self._resend_for(cid, attempt, missing)
                for cid, (attempt, missing) in self._rx.incomplete().items()]

    def resend_request(self, client_id: int) -> "Optional[bytes]":
        """A targeted RESEND for ONE client's incomplete reassembly (None
        when the client has no open incomplete stream)."""
        info = self._rx.incomplete().get(client_id)
        if info is None:
            return None
        return self._resend_for(client_id, *info)

    # ------------------------------------------------------------ FINALIZE
    def finalize(self) -> "tuple[torch.Tensor, RoundStats]":
        """Drain anything still pending and return (mean (d,), stats).

        The mean is a tensor on the server's device, over the accepted
        senders; with zero accepts it is zeros (the round anchor in
        anchored rounds).  Bit-identical for any arrival order of the same
        accepted payload set."""
        self.drain()
        if _obs.tracing_enabled() and not self._publish_traced:
            self._publish_traced = True
            tr = _obs.tracer()
            tr.event("publish", parent=("round", self.spec.round_id),
                     round=self.spec.round_id, accepted=len(self._accepted))
            tr.end(("round", self.spec.round_id))
        if self._count == 0:
            if not self.spec.anchored:
                return (torch.zeros((self.spec.d,), dtype=torch.float32,
                                    device=self.device), self.stats)
            return rounds.unbucketize(self._anchor_b, self.spec), self.stats
        ksum = self._ksum
        if self._ksum_st is not None:
            # merge the streamed commits — exact int64 -> int32, safe under
            # the same count * max|k| < 2^31 bound as the batched drain
            ksum = ksum + self._ksum_st.reshape(ksum.shape).to(torch.int32)
        mean_b = _mean_math(ksum, self._count, self._u, self._sides[:, None])
        if self.spec.anchored:
            mean_b = mean_b + self._anchor_b
        return rounds.unbucketize(mean_b, self.spec), self.stats
