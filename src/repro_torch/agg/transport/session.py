"""Session layer: out-of-order, duplicate-tolerant chunk reassembly.

One :class:`Reassembler` serves one round.  Within a client, concurrent
chunk streams are keyed by ``(attempt, payload_crc)`` — every frame of one
payload carries the same body seal, so chunks of different payloads can
NEVER be spliced together, and a forged or cross-wired frame for a client
id opens (at worst) its own doomed sub-session instead of capturing the
honest client's: first-writer-wins livelock is structurally impossible.
At most :data:`MAX_SESSIONS_PER_CLIENT` sub-sessions are kept per client
(the honest stream plus one interloper); beyond that the least-complete,
oldest stream is evicted — an evicted honest stream rebuilds through the
drain's RESEND retransmits, which always follow the client's
most-complete open stream.

Each CRC-validated chunk is committed *in place* into its stream's
preallocated body buffer (chunk k always lives at ``k * mtu``), so the
transport keeps NO reorder stash: the only bytes ever staged before
validation are the single frame currently being processed (<= frame header
+ MTU), independent of the vector length d.  The body buffer itself is not
transport overhead — it is byte-for-byte the packed payload the server
must hold for the batched drain anyway (the completed
:class:`~repro_torch.agg.transport.frame.Payload` views the same buffer,
zero-copy), exactly like the v2 single-frame pending store; under
impersonation the cap bounds it at MAX_SESSIONS_PER_CLIENT bodies.

Reassembly state machine, per (client, attempt, payload_crc) stream:

    EMPTY --chunk--> PARTIAL --last chunk + payload_crc ok--> COMPLETE
      PARTIAL --duplicate index-->        PARTIAL   [counted, dropped]
      PARTIAL --higher-attempt stream-->  evicted   [escalation resets]
      PARTIAL --foreign payload_crc-->    (separate stream)  [conflict]
      PARTIAL --group over cap-->         least-complete evicted
      COMPLETE --payload CRC mismatch-->  EMPTY     [retryable: RESEND all]

A completed stream retires the client's whole group (any other partial is
an interloper or a superseded duplicate; the server's pending-payload
dedupe absorbs re-deliveries).  A completed body that fails its end-to-end
``payload_crc`` seal (only reachable when a forged chunk shared an honest
stream's exact header) is dropped and reported retryable — the caller
answers ``STATUS_RESEND`` for every chunk rather than a terminal REJECT,
so a forged frame can never flip an honest client to gave-up.
Missing-chunk NACKs are derived from :meth:`Reassembler.incomplete` at
drain time, so retransmits carry *only* the absent indices.

**Streaming mode** (v5, enabled by passing ``on_range_validated``): instead
of committing chunks into a preallocated body buffer, each stream tracks
its contiguous-from-zero validated prefix (the cumulative-ack high-water
mark).  As the prefix advances, the packed-word region it newly covers is
emitted to the callback in whole uint32 words — ``on_range_validated(h,
word_start, words)`` — and the chunk bytes are FREED; only out-of-order
chunks beyond a gap (bounded by the send window), a sub-word carry
(< 4 bytes), and the tail sides sidecar are retained.  The end-to-end
``payload_crc`` seal is computed incrementally over the prefix, so at
completion it equals the full-body CRC bit for bit.  Because ranges are
folded *speculatively* before the seal verdict, every stream dropped after
emitting anything (seal failure, escalation reset, eviction, conflict,
discard) notifies ``on_stream_discarded(h)`` so the consumer rolls back
its per-stream partial; a stream that completes with the seal intact is
the one case that does NOT notify.  The event vocabulary, duplicate
semantics (first write wins per index), eviction policy and missing-index
arithmetic are identical to the sealed mode — only where bytes live
changes.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

import numpy as np

import repro_torch.obs as _obs
from repro_torch.agg.transport import frame as F

# honest stream + one interloper; beyond that, evict the least complete
MAX_SESSIONS_PER_CLIENT = 2

# add() events
COMPLETE = "complete"      # last chunk landed; payload verified + returned
PROGRESS = "progress"      # chunk committed; more outstanding
DUPLICATE = "duplicate"    # chunk index already committed (idempotent)
STALE = "stale"            # below the client's newest in-flight attempt:
                           # dropped — a stale stream must never exist (it
                           # would capture RESEND targeting / a cap slot)
REJECT = "reject"          # reassembled body failed the payload-CRC seal
                           # (stream dropped; retryable via RESEND-all)


@dataclasses.dataclass
class ReassemblyStats:
    """Transport-layer telemetry of one round's reassembly."""
    chunks: int = 0              # chunk frames fed to add()
    completed: int = 0           # payloads fully reassembled + verified
    duplicates: int = 0
    stale: int = 0               # chunks below the client's newest attempt
    conflicts: int = 0           # foreign streams opened alongside another
    evictions: int = 0           # streams dropped by the per-client cap
    rejects: int = 0             # payload-CRC seal failures at completion
    resets: int = 0              # streams superseded by a higher attempt
    buffer_bytes: int = 0        # bytes currently held by open streams
    peak_buffer_bytes: int = 0   # high-water mark of open-stream bytes


@dataclasses.dataclass
class _Stream:
    header: F.FrameHeader        # first-seen header (chunk_index-normalized)
    buf: bytearray
    have: set
    born: int                    # arrival order, for eviction tie-breaks
    prefix: int = 0              # contiguous-from-zero chunks committed (the
                                 # stream's cumulative-ack high-water mark)
    # streaming-mode state (unused, and empty, in sealed mode)
    crc: int = 0                 # incremental payload CRC over the prefix
    carry: bytearray = dataclasses.field(default_factory=bytearray)
    held: dict = dataclasses.field(default_factory=dict)   # idx -> bytes
    held_bytes: int = 0
    sides: bytearray = dataclasses.field(default_factory=bytearray)
    words_emitted: int = 0
    emitted: bool = False        # any range handed to on_range_validated
    completed: bool = False      # seal verified; suppress rollback notify

    # a chunk belongs to this stream iff it agrees on every header field
    # except its own position — payload_crc keys the body, so two
    # different payloads can never merge
    def matches(self, h: F.FrameHeader) -> bool:
        return dataclasses.replace(h, chunk_index=0) == self.header

    @property
    def progress(self) -> int:
        return len(self.have)

    @property
    def store_bytes(self) -> int:
        """Bytes this stream currently retains (the pending-store share):
        the whole body buffer in sealed mode; just the out-of-order stash,
        sub-word carry and sides sidecar in streaming mode."""
        return (len(self.buf) + self.held_bytes + len(self.carry)
                + len(self.sides))


class Reassembler:
    """Per-round chunk reassembly keyed by client id.

    ``on_range_validated(h, word_start, words)`` switches the round to
    streaming mode (see the module docstring); ``on_stream_discarded(h)``
    is the matching rollback notification for speculatively-folded streams
    that die before their seal verifies.
    """

    def __init__(self, spec: F.RoundSpec,
                 on_range_validated: "Optional[Callable]" = None,
                 on_stream_discarded: "Optional[Callable]" = None):
        self.spec = spec
        self._groups: "dict[int, list[_Stream]]" = {}
        self._born = 0
        self._on_range = on_range_validated
        self._on_discard = on_stream_discarded
        self.streaming = on_range_validated is not None
        self.stats = ReassemblyStats()

    def _drop(self, client_id: int, s: _Stream) -> None:
        self._groups[client_id].remove(s)
        self.stats.buffer_bytes -= s.store_bytes
        if not self._groups[client_id]:
            del self._groups[client_id]
        # rollback notification: this stream's ranges were folded
        # speculatively and its seal will now never verify
        if s.emitted and not s.completed and self._on_discard is not None:
            self._on_discard(s.header)

    def _open(self, h: F.FrameHeader) -> _Stream:
        group = self._groups.setdefault(h.client_id, [])
        # escalation supersedes: a new attempt's stream retires all
        # lower-attempt partials of this client
        for s in [s for s in group if s.header.attempt < h.attempt]:
            self.stats.resets += 1
            self._drop(h.client_id, s)
        group = self._groups.setdefault(h.client_id, [])
        if group:
            self.stats.conflicts += 1
        if len(group) >= MAX_SESSIONS_PER_CLIENT:
            victim = min(group, key=lambda s: (s.progress, s.born))
            self.stats.evictions += 1
            self._drop(h.client_id, victim)
            group = self._groups.setdefault(h.client_id, [])
        self._born += 1
        if self.streaming:
            # no body buffer: the prefix folds away as it validates; only
            # the sides tail (needed whole for the spec check) is staged
            s = _Stream(header=dataclasses.replace(h, chunk_index=0),
                        buf=bytearray(0), have=set(), born=self._born,
                        sides=bytearray(4 * h.nb))
        else:
            s = _Stream(header=dataclasses.replace(h, chunk_index=0),
                        buf=bytearray(h.body_len), have=set(),
                        born=self._born)
        group.append(s)
        self.stats.buffer_bytes += s.store_bytes
        self._note_peak(h.round_id)
        if _obs.tracing_enabled():
            _obs.tracer().begin(
                "reassembly", key=("reassembly", h.round_id, h.client_id),
                parent=("client", h.round_id, h.client_id),
                round=h.round_id, client=h.client_id, attempt=h.attempt,
                n_chunks=h.n_chunks)
        return s

    def _note_peak(self, round_id: int) -> None:
        self.stats.peak_buffer_bytes = max(self.stats.peak_buffer_bytes,
                                           self.stats.buffer_bytes)
        if _obs.metrics_enabled():
            _obs.gauge("peak_staging_bytes", round=round_id).set_max(
                self.stats.buffer_bytes)

    def add(self, h: F.FrameHeader, chunk: bytes
            ) -> "tuple[str, Optional[F.Payload]]":
        """Commit one validated chunk; returns (event, payload-or-None).

        The caller has already run :func:`frame.decode_frame` (per-frame
        CRC) and :func:`frame.check_frame_against_spec` (round membership +
        MTU geometry), so everything arriving here is a well-formed chunk of
        *some* payload of this round.
        """
        self.stats.chunks += 1
        group = self._groups.get(h.client_id, [])
        if any(s.header.attempt > h.attempt for s in group):
            # drop, don't open: a lower-attempt stream alongside the
            # escalated one could out-progress it, capture the client's
            # single RESEND slot (incomplete() is per client) and deadlock
            # the escalation — and it would burn a cap slot
            self.stats.stale += 1
            return STALE, None
        s = next((s for s in group if s.matches(h)), None)
        if s is None:
            s = self._open(h)
        if h.chunk_index in s.have:
            self.stats.duplicates += 1
            return DUPLICATE, None
        if self.streaming:
            return self._add_streaming(h, s, chunk)
        # only multi-chunk frames reach the session (single frames bypass
        # it in the server), and those exist only under a positive MTU
        off = h.chunk_index * self.spec.mtu
        s.buf[off:off + len(chunk)] = chunk
        s.have.add(h.chunk_index)
        while s.prefix in s.have:        # cumulative-ack high-water mark
            s.prefix += 1
        if len(s.have) < h.n_chunks:
            return PROGRESS, None
        # complete: seal the body end to end before it can reach the drain
        # (crc32 hashes the bytearray in place — no body-sized copy)
        if zlib.crc32(s.buf) != h.payload_crc:
            return self._seal_reject(h, s)
        self.stats.completed += 1
        if _obs.tracing_enabled():
            _obs.tracer().end(("reassembly", h.round_id, h.client_id))
        self.discard(h.client_id)        # retire the whole group
        return COMPLETE, F.payload_from_body(s.header, s.buf)

    def _seal_reject(self, h: F.FrameHeader, s: _Stream):
        self.stats.rejects += 1
        self._drop(h.client_id, s)       # retryable: caller RESENDs all
        if _obs.metrics_enabled():
            _obs.counter("payload_crc_seal_failures",
                         round=h.round_id).inc()
        if _obs.tracing_enabled():
            _obs.tracer().end(
                ("reassembly", h.round_id, h.client_id), rejected=True)
        _obs.trigger("payload_crc_seal_failure",
                     at=_obs.tracer().now(),
                     round=h.round_id, client=h.client_id)
        return REJECT, None

    def _add_streaming(self, h: F.FrameHeader, s: _Stream, chunk: bytes):
        """Streaming-mode commit: advance the validated prefix (emitting +
        freeing the word ranges it covers) or stash an out-of-order chunk
        until its gap fills."""
        idx = h.chunk_index
        s.have.add(idx)
        if idx == s.prefix:
            self._advance(s, chunk)
            while s.prefix in s.held:
                nxt = s.held.pop(s.prefix)
                s.held_bytes -= len(nxt)
                self.stats.buffer_bytes -= len(nxt)
                self._advance(s, nxt)
        else:
            s.held[idx] = bytes(chunk)
            s.held_bytes += len(chunk)
            self.stats.buffer_bytes += len(chunk)
            self._note_peak(h.round_id)
        if s.prefix < h.n_chunks:
            return PROGRESS, None
        # complete: the incremental CRC over the in-order prefix IS the
        # end-to-end body seal (the prefix is the whole body here)
        if s.crc != h.payload_crc:
            return self._seal_reject(h, s)
        s.completed = True               # suppress the rollback notify
        self.stats.completed += 1
        if _obs.tracing_enabled():
            _obs.tracer().end(("reassembly", h.round_id, h.client_id))
        p = F.streamed_payload(s.header, bytes(s.sides))
        self.discard(h.client_id)        # retire the whole group
        return COMPLETE, p

    def _advance(self, s: _Stream, chunk: bytes) -> None:
        """Fold one frontier chunk into the prefix: emit the whole words it
        completes, stage any sides-tail portion, free the rest."""
        h = s.header
        off = s.prefix * self.spec.mtu
        s.crc = zlib.crc32(chunk, s.crc)
        wb = 4 * h.n_words
        mv = memoryview(chunk)
        carry0 = len(s.carry)
        w_end = max(0, min(len(chunk), wb - off))
        if w_end:
            s.carry += mv[:w_end]
            n_emit = len(s.carry) // 4
            if n_emit:
                words = np.frombuffer(bytes(s.carry[:4 * n_emit]),
                                      dtype="<u4")
                s.emitted = True
                self._on_range(h, s.words_emitted, words)
                s.words_emitted += n_emit
                del s.carry[:4 * n_emit]
        if w_end < len(chunk):
            so = off + w_end - wb
            s.sides[so:so + len(chunk) - w_end] = mv[w_end:]
        self.stats.buffer_bytes += len(s.carry) - carry0
        s.prefix += 1

    def missing(self, client_id: int) -> "tuple[int, ...]":
        """Outstanding chunk indices across ALL of a client's open streams
        (they share one attempt — stale ones are dropped, higher ones
        evict).  The union matters: following only the most-complete
        stream would let a forged stream that out-progresses the honest
        one capture the client's single RESEND slot and livelock it; with
        the union, the honest stream's gaps are always named too, its
        retransmits merge into it, and it completes regardless of what an
        interloper does."""
        group = self._groups.get(client_id)
        if not group:
            return ()
        have_all = set.intersection(*(s.have for s in group))
        return tuple(i for i in range(group[0].header.n_chunks)
                     if i not in have_all)

    def high_water(self, client_id: int) -> int:
        """Cumulative-ack value for a client: the largest contiguous-from-
        zero chunk count across its open streams (0 when none are open;
        the server acks a completed client at the full chunk count)."""
        group = self._groups.get(client_id)
        if not group:
            return 0
        return max(s.prefix for s in group)

    def incomplete(self) -> "dict[int, tuple]":
        """client_id -> (attempt, missing indices) of every open client."""
        return {cid: (g[0].header.attempt, self.missing(cid))
                for cid, g in sorted(self._groups.items())}

    def open_clients(self) -> frozenset:
        """Client ids with at least one open (incomplete) stream — the
        reassembly half of the server's bounded pending store."""
        return frozenset(self._groups)

    def discard(self, client_id: int) -> None:
        """Drop a client's open streams (accepted / gave-up clients)."""
        group = list(self._groups.get(client_id, []))
        if group and _obs.tracing_enabled():
            # idempotent: already-completed streams ended their span above
            _obs.tracer().end(("reassembly", self.spec.round_id, client_id),
                              discarded=True)
        for s in group:
            self._drop(client_id, s)

    @property
    def open_sessions(self) -> int:
        return sum(len(g) for g in self._groups.values())
