"""Layered streaming transport for the aggregation protocol.

Three layers, lowest first:

* :mod:`repro_torch.agg.transport.frame` — the versioned byte codec: one
  self-describing v3 frame header (round/client identity, lattice geometry,
  §5 checksum, anchor digest, chunk coordinates ``n_chunks``/``chunk_index``
  and the whole-payload ``payload_crc``) + per-frame CRC-32.  Also the
  round's protocol contract (:class:`RoundSpec`) and the response codec.
* :mod:`repro_torch.agg.transport.chunks` — splits a packed payload body into
  fixed-MTU chunks, each independently framed, CRC'd and idempotently
  re-sendable; selective retransmit re-sends *only* the chunks a
  ``STATUS_RESEND`` response names.
* :mod:`repro_torch.agg.transport.session` — out-of-order, duplicate-tolerant
  server-side reassembly: validated chunks are committed in place into a
  preallocated body buffer (no reorder stash), so the transport's own
  staging memory is bounded by one frame (header + MTU) per in-flight
  receive, independent of the vector length d.

The byte arithmetic of every layer delegates to
:mod:`repro_torch.core.wire_accounting` — the repo's single wire-byte definition.
"""
from repro_torch.agg.transport.frame import (  # noqa: F401
    FrameHeader, Payload, Response, RoundSpec, WireError,
    TruncatedPayloadError, BadMagicError, VersionMismatchError,
    CorruptPayloadError, HeaderMismatchError, MAGIC_PAYLOAD, MAGIC_RESPONSE,
    WIRE_VERSION, Q_CAP, FLAG_ROTATE, FLAG_ANCHORED,
    FRAME_HEADER_BYTES, STATUS_QUEUED, STATUS_ACK, STATUS_NACK,
    STATUS_REJECT, STATUS_RESEND, STATUS_RETRY, encode_frame, decode_frame,
    decode_payload, peek_route, payload_from_body,
    build_payload, encode_payload, encode_response, decode_response,
    check_against_spec, check_frame_against_spec, check_sides_against_spec,
    payload_bytes, q_at_attempt, y_at_attempt, y_buckets_at_attempt)
from repro_torch.agg.transport.chunks import (  # noqa: F401
    encode_chunks, chunk_frames, select)
from repro_torch.agg.transport.session import Reassembler, ReassemblyStats  # noqa: F401
