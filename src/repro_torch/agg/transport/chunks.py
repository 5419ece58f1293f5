"""Chunk layer: fixed-MTU splitting of a packed payload body into frames.

A payload body larger than the round's MTU is split into
``ceil(body/mtu)`` chunks; every chunk except the last carries exactly
``mtu`` bytes, so chunk k always covers ``body[k*mtu : k*mtu + mtu]`` and a
receiver can place any chunk without having seen the others.  Each chunk is
wrapped in its own self-describing v3 frame (full header + per-frame CRC):
independently validatable, idempotently re-sendable, and individually
retransmittable — a corrupt or dropped byte costs ONE chunk frame on the
wire, never the payload (the server's STATUS_RESEND response names exactly
the missing chunk indices; see :mod:`repro_torch.agg.transport.session`).

The byte geometry (chunk count, spans, per-frame overhead) delegates to
:mod:`repro_torch.core.wire_accounting`.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

import repro_torch.obs as _obs
from repro_torch.agg.transport import frame as F
from repro_torch.core import wire_accounting as WA


def chunk_frames(h0: F.FrameHeader, body: bytes, mtu: int) -> "list[bytes]":
    """Frame a complete body as its chunk sequence under an MTU.

    ``h0`` supplies the payload-level header fields; n_chunks, chunk_index
    and payload_crc are (re)derived here so the chunk coordinates can never
    disagree with the body actually framed.
    """
    nc = WA.n_chunks(len(body), mtu)
    with _obs.span("frame.crc", round=h0.round_id, client=h0.client_id):
        pcrc = zlib.crc32(body)
    if _obs.metrics_enabled():
        _obs.counter("frame_crc_bytes").inc(len(body))
    hs = [dataclasses.replace(h0, n_chunks=nc, chunk_index=i,
                              payload_crc=pcrc) for i in range(nc)]
    return F.encode_frames(hs, body, [WA.chunk_span(len(body), mtu, i)
                                      for i in range(nc)])


def encode_chunks(spec: F.RoundSpec, client_id: int, attempt: int, q: int,
                  words: np.ndarray, sides: np.ndarray,
                  check: int, n_summed: int = 1) -> "list[bytes]":
    """Serialize one client message as its chunk-frame sequence (one frame
    when the body fits the MTU or the round is unchunked — in which case
    the single frame is byte-identical to :func:`frame.encode_payload`,
    whose header builder this delegates to).  ``n_summed`` > 1 marks a tree
    tier's combined payload (how many accepted clients it folded in)."""
    h0, body = F.build_payload(spec, client_id, attempt, q, words, sides,
                               check, n_summed=n_summed)
    return chunk_frames(h0, body, spec.mtu)


class SendWindow:
    """Credit-based pacing of one attempt's chunk-frame sequence (v5).

    The sender keeps at most ``window`` chunks in flight — sent but not yet
    covered by the server's cumulative contiguous ack (``Response.ack``,
    the v5 additive flow-control field; the static grant rides
    ``Response.credit``).  ``sendable()`` returns the next frames the
    credit allows and every response's ack feeds :meth:`note_ack` — RESEND
    recovery re-sends only chunks below the sent prefix (``next``), so a
    drain-time RESEND that names credit-blocked chunks never defeats the
    window.  A response that unblocks nothing while frames remain is a
    *window stall* (counted here and exported as the ``window_stalls`` obs
    counter): the sender is blocked on in-flight chunks — the backpressure
    signal the open-loop driver models (``repro.agg.sim`` in the reference)."""

    def __init__(self, frames: "list[bytes]", window: int):
        self.frames = frames
        self.window = window
        self.next = 0       # lowest chunk index never sent
        self.ack = 0        # server's cumulative contiguous-chunk ack
        self.stalls = 0

    @property
    def done(self) -> bool:
        return self.next >= len(self.frames)

    @property
    def in_flight(self) -> int:
        return max(self.next - self.ack, 0)

    def note_ack(self, ack: int) -> None:
        """Fold in a response's cumulative ack (monotonic; never rewinds)."""
        if ack > self.ack:
            self.ack = min(ack, len(self.frames))

    def unacked(self) -> "list[bytes]":
        """The in-flight (sent, unacked) frames — the timeout-retransmit
        set: when every copy was lost the server has no stream to RESEND
        from, so recovery must come from the sender's own timer."""
        return list(self.frames[self.ack:self.next])

    def sendable(self) -> "list[bytes]":
        """The frames the current credit allows on the wire now."""
        end = min(self.ack + self.window, len(self.frames))
        out = self.frames[self.next:end]
        if out:
            self.next = end
        elif not self.done:
            self.stalls += 1
            if _obs.metrics_enabled():
                _obs.counter("window_stalls").inc()
        return out


def select(frames: "list[bytes]", missing: "tuple[int, ...]"
           ) -> "list[bytes]":
    """The selective-retransmit set: only the frames a STATUS_RESEND names.

    Out-of-range indices mean the response is corrupt or belongs to a
    different attempt's geometry — fall back to re-sending everything
    (idempotent, so over-sending is safe; under-sending would deadlock)."""
    if not missing or any(i >= len(frames) for i in missing):
        out = list(frames)
    else:
        out = [frames[i] for i in missing]
    if _obs.metrics_enabled():
        _obs.counter("chunk_retransmit_frames").inc(len(out))
    return out
