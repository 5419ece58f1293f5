"""Client side of the aggregation protocol: encode, chunk, retransmit;
counterpart of ``repro.agg.client``.

A client holds one local vector for one round.  Encoding bucketizes it
(with the optional §6 HD rotation through the FWHT kernel), then one launch
of the fused encode kernel subtracts the round anchor (anchored rounds),
divides by the per-bucket side, dithers, rounds to integer lattice
coordinates and packs the mod-q colors into 32-bit words.  The kernel
reads the (nb,) per-bucket sides directly; the per-coordinate broadcast is
never built.  The integer coordinates are independent of the attempt
level — escalation only widens the color space (q <- q^2) — so a retry
re-packs the same coordinates at more bits and the §5 checksum h(k) never
changes.

Transport, escalation and the credit window follow the reference exactly
(see ``repro.agg.client``): frames are cached per attempt so a retransmit
is byte-identical, ``handle_response`` returns the frames to send next for
RESEND / NACK / windowed QUEUED responses, RETRY is non-terminal, and
REJECT is terminal.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import repro_torch.obs as _obs
from repro_torch import resolve_device
from repro_torch.agg import rounds
from repro_torch.agg.transport import chunks as C
from repro_torch.agg.transport import frame as wire
from repro_torch.core import error_detect as ED
from repro_torch.core import lattice as L
from repro_torch.kernels import ops as K


class AggClient:
    """One client's state for one aggregation round.

    ``x`` (and ``anchor`` in anchored rounds) may be numpy arrays or
    tensors; they are moved to ``device`` — the CUDA device unless the
    caller names another."""

    def __init__(self, spec: wire.RoundSpec, client_id: int, x,
                 anchor=None, device=None):
        if tuple(np.shape(x)) != (spec.d,):
            raise ValueError(f"x has shape {tuple(np.shape(x))}, "
                             f"spec.d={spec.d}")
        rounds.check_anchor(spec, anchor)
        self.spec = spec
        self.client_id = client_id
        self.device = resolve_device(device)
        self.attempt = 0
        self.acked = False
        self.gave_up = False
        # set by a non-terminal STATUS_RETRY: the round id currently open
        # for admission (this round: re-send after backoff; another round:
        # re-enroll there; None: no hint).  Never terminal.
        self.retry_round: Optional[int] = None
        self._xflat = rounds.bucketize(rounds.as_f32(x, self.device),
                                       spec).reshape(-1)
        self._aflat = (rounds.bucketize(rounds.as_f32(anchor, self.device),
                                        spec).reshape(-1)
                       if spec.anchored else None)
        self._u = rounds.dither(spec, self.device).reshape(-1)
        self._sides = rounds.sides(spec, self.device)          # (nb,)
        self._check: Optional[int] = None
        self._words: "dict[int, tuple[int, np.ndarray]]" = {}
        self._frames: "dict[int, list[bytes]]" = {}
        self._win: "dict[int, C.SendWindow]" = {}   # attempt -> window

    def encode(self, attempt: Optional[int] = None
               ) -> "tuple[int, np.ndarray]":
        """(q, packed uint32 words on the host) at an escalation level,
        cached per attempt.  The §5 checksum over the integer coordinates
        is computed once, on the first encode (it never changes)."""
        if attempt is None:
            attempt = self.attempt
        cached = self._words.get(attempt)
        if cached is not None:
            return cached
        q = wire.q_at_attempt(self.spec.cfg.q, attempt)
        bucket = self.spec.cfg.bucket
        rid, cid = self.spec.round_id, self.client_id
        if self._check is None:
            words, k = K.lattice_encode(self._xflat, self._u, self._sides,
                                        q=q, return_coords=True,
                                        anchor=self._aflat, bucket=bucket)
            with _obs.span("client.checksum", round=rid, client=cid):
                self._check = int(ED.coord_checksum(
                    k, rounds.checksum_weights(self.spec, self.device)))
            del k
        else:
            words = K.lattice_encode(self._xflat, self._u, self._sides, q=q,
                                     anchor=self._aflat, bucket=bucket)
        nw = L.packed_len(self.spec.padded, L.bits_for_q(q))
        with _obs.span("client.d2h", round=rid, client=cid):
            host = words[:nw].cpu().numpy().view(np.uint32)
        self._words[attempt] = (q, host)
        return q, host

    def frames(self, attempt: Optional[int] = None) -> "list[bytes]":
        """This client's chunk-frame sequence at an escalation level
        (cached: a retransmit is byte-identical)."""
        if attempt is None:
            attempt = self.attempt
        cached = self._frames.get(attempt)
        if cached is None:
            trace = _obs.tracing_enabled()
            if trace:
                _obs.tracer().begin(
                    "encode",
                    key=("client", self.spec.round_id, self.client_id),
                    parent=("round", self.spec.round_id),
                    round=self.spec.round_id, client=self.client_id,
                    attempt=attempt)
            q, words = self.encode(attempt)
            cached = C.encode_chunks(self.spec, self.client_id, attempt, q,
                                     words, self.spec.sides_np(),
                                     self._check)
            self._frames[attempt] = cached
            if trace:
                _obs.tracer().end(
                    ("client", self.spec.round_id, self.client_id),
                    n_chunks=len(cached))
        return list(cached)

    def _window(self, attempt: int) -> "C.SendWindow":
        w = self._win.get(attempt)
        if w is None:
            w = self._win[attempt] = C.SendWindow(self.frames(attempt),
                                                  self.spec.window)
        return w

    def send_frames(self, attempt: Optional[int] = None) -> "list[bytes]":
        """The frames to put on the wire NOW: the whole chunk sequence in
        an unwindowed round, else the first credit-limited burst."""
        if attempt is None:
            attempt = self.attempt
        if not self.spec.window:
            return self.frames(attempt)
        return self._window(attempt).sendable()

    def retransmit_frames(self) -> "list[bytes]":
        """Timeout recovery: the unacked in-flight window (windowed rounds)
        or the full chunk sequence (unwindowed); empty after a verdict."""
        if self.acked or self.gave_up:
            return []
        if not self.spec.window:
            return self.frames(self.attempt)
        w = self._window(self.attempt)
        return w.unacked() or w.sendable()

    @property
    def window_stalls(self) -> int:
        """Responses that unblocked nothing while chunks remained unsent."""
        return sum(w.stalls for w in self._win.values())

    def payload(self, attempt: Optional[int] = None) -> bytes:
        """The single-frame serialization (unchunked rounds, and chunked
        rounds whose body fits one MTU)."""
        frames = self.frames(attempt)
        if len(frames) != 1:
            raise ValueError(
                f"payload spans {len(frames)} chunks at mtu "
                f"{self.spec.mtu}; use frames()")
        return frames[0]

    def handle_response(self, data: bytes) -> "list[bytes]":
        """Process a server response; returns the frames to send next
        (empty when no send is needed: ACK/QUEUED, terminal REJECT, or
        escalation exhausted — ``gave_up`` is set in the latter two)."""
        r = wire.decode_response(data)
        if r.client_id != self.client_id or r.round_id != self.spec.round_id:
            return []
        if r.status in (wire.STATUS_ACK, wire.STATUS_QUEUED):
            # set on ACK only — a reordered/late chunk QUEUED must never
            # clear an ACK verdict
            self.acked = self.acked or r.status == wire.STATUS_ACK
            if (self.acked or not self.spec.window
                    or r.status != wire.STATUS_QUEUED
                    or r.attempt_next != self.attempt):
                return []
            # windowed round: the QUEUED's cumulative ack is the credit
            # return — send whatever the window now allows
            w = self._window(self.attempt)
            w.note_ack(r.ack)
            return w.sendable()
        if r.status == wire.STATUS_RETRY:
            self.retry_round = r.q_next or None
            return []
        if r.status == wire.STATUS_REJECT:
            self.gave_up = True
            return []
        if self.acked or self.gave_up:
            return []                      # late NACK/RESEND after a verdict
        if r.status == wire.STATUS_RESEND:
            if r.attempt_next != self.attempt:
                return []                  # stale: that attempt is gone
            frames = self.frames(self.attempt)
            if self.spec.window:
                # only chunks below the contiguous sent prefix were lost;
                # the rest ride the normal ack path
                w = self._window(self.attempt)
                w.note_ack(r.ack)
                lost = tuple(i for i in r.missing if i < w.next)
                out = C.select(frames, lost) if lost else []
                return out + w.sendable()
            return C.select(frames, r.missing)
        # NACK: escalate to the server-directed attempt (RobustAgreement:
        # the color space squares, the per-bucket granularity stays fixed)
        if len(r.y_buckets) != self.spec.nb:
            # corrupt/foreign NACK: retransmit and let the server re-judge
            return self.frames(self.attempt)
        if r.attempt_next >= self.spec.max_attempts:
            self.gave_up = True
            return []
        if r.attempt_next <= self.attempt:
            return []                      # duplicate/stale NACK
        self.attempt = r.attempt_next
        if self.spec.window:
            return self._window(self.attempt).sendable()
        return self.frames(self.attempt)
