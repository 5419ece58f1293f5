"""Frame layer: the versioned byte codec of the aggregation protocol (v5).

One transport frame carries one *chunk* of a client's packed payload body
(the whole body when it fits the round's MTU) behind a fixed self-describing
header.  Frame layout, little-endian (header arithmetic pinned in
:mod:`repro_torch.core.wire_accounting`):

    offset  size  field
    0       4     magic         b"DMEA"
    4       2     version       WIRE_VERSION (5)
    6       2     flags         bit 0: rotate (HD pre-rotation, paper §6)
                                bit 1: anchored (encoded x - anchor)
    8       4     round_id
    12      4     client_id
    16      4     attempt       escalation level (0 on first send)
    20      4     q             color classes at this attempt (q0^(2^attempt))
    24      4     d             unpadded vector length
    28      4     bucket        coordinates per bucket (power of two)
    32      4     seed          round's shared-randomness seed (dither u)
    36      4     rot_seed      shared Hadamard-diagonal seed
    40      4     n_words       packed uint32 word count of the FULL body
    44      4     nb            bucket count (= padded d / bucket)
    48      4     check         coordinate checksum h(k) (core.error_detect)
    52      4     anchor_digest CRC-32 of the round anchor (0 = unanchored)
    56      4     n_chunks      chunks the body was split into (1 = unchunked)
    60      4     chunk_index   which chunk this frame carries
    64      4     payload_crc   CRC-32 of the FULL body (all chunks joined)
    68      4     n_summed      ADDITIVE client count this payload sums
                                (1 = an ordinary client; a tree tier
                                forwarding a combined payload carries how
                                many accepted clients it folded in)
    72      4     crc           CRC-32 of this frame (header zero-crc + chunk)
    76      ...   chunk bytes   body[chunk_index*mtu : +mtu] (packed words
                                then the f32 sides sidecar; the MTU is the
                                round's, pinned in RoundSpec)

Every frame repeats the full header, so any chunk alone identifies its
round, client, attempt, lattice geometry and position — a receiver can
validate and place chunk k without having seen chunks 0..k-1, and a
retransmitted chunk is byte-identical (idempotent).  The per-frame ``crc``
protects each chunk independently — a corrupt byte costs one chunk
retransmit, never the payload — while ``payload_crc`` seals the reassembled
body end to end.

The payload body is exactly the packed wire format of the quantized
collectives (repro.dist.collectives): uint32 words from the fused
encode plus the per-bucket sides sidecar.  Escalation follows
RobustAgreement (paper Alg. 5) with the lattice granularity held fixed: the
round pins the sides s_b = 2*y_b/(q0-1) and each retry squares the color
space, q <- q^2 (capped at 2^16), so integer coordinates from different
attempts remain summable.

Server responses (v5) carry the per-bucket decode margins, the streaming
flow-control state (cumulative ack + send-window credit) and — for
``STATUS_RESEND`` — the missing chunk indices of an incomplete reassembly:

    magic b"DMER" | version u16 | status u16 | round_id u32 | client_id u32
    | attempt_next u32 | q_next u32 | y_next f32 | nb u32 | n_missing u32
    | ack u32 | credit u32 | y_buckets f32*nb | missing u32*n_missing
    | crc u32

v2 -> v3 migration: the v2 single-frame header (56 bytes + CRC) grew the
three chunk fields (n_chunks / chunk_index / payload_crc, +12 bytes); a v2
payload is exactly a v3 frame with n_chunks=1, chunk_index=0 and
payload_crc over the same body.  v2 frames are refused with
VersionMismatchError — there is no silent fallback, because a v2 sender
cannot participate in chunked reassembly or selective retransmit.

v3 -> v4 migration: one additive field, ``n_summed``, appended after
``payload_crc`` (header 68 -> 72 bytes before the CRC word).  Every field
keeps its v3 offset; an ordinary client always sends n_summed=1, and a v3
payload is exactly a v4 payload with n_summed=1.  A tree tier
(``repro.agg.tree`` in the reference) that folded m accepted clients into one combined
payload forwards it with n_summed=m, so the root can weight its integer
coordinate sum by the true client count without decoding anything at the
tier.  v3 frames are refused with VersionMismatchError, same policy as
v2 -> v3.

v4 -> v5 migration: same additive-field policy, on the RESPONSE side this
time (the frame layout is unchanged).  Two u32 fields, ``ack`` and
``credit``, are appended to the response head after ``n_missing`` (head
36 -> 44 bytes); every earlier field keeps its v4 offset.  ``ack`` is the
cumulative count of contiguous-from-zero chunks the server holds for the
client's live stream (a TCP-style cumulative ack: chunks received out of
order beyond a gap are buffered but not acked), and ``credit`` is how many
chunks the client may have in flight beyond ``ack`` (the round's
``RoundSpec.window``; 0 = unwindowed, send freely — the v4 behaviour).
RESEND and window advance share this one response path: a RESEND names the
gap chunks while ack/credit tell the sender how far its fresh-data window
has slid.  v4 responses are refused with VersionMismatchError, same policy
as the frame-side bumps.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

import repro_torch.obs as _obs
from repro_torch.core import lattice as L
from repro_torch.core import wire_accounting as WA
from repro_torch.dist.collectives import (QSyncConfig, flat_size_padded,
                                    _ROTATION_SEED)

MAGIC_PAYLOAD = b"DMEA"
MAGIC_RESPONSE = b"DMER"
WIRE_VERSION = 5
Q_CAP = 1 << 16                   # largest packable color space (16 bits)

FLAG_ROTATE = 1 << 0
FLAG_ANCHORED = 1 << 1

_HEADER = struct.Struct("<4sHH16I")
# response header up to and including the v5 ack/credit pair; followed by
# nb f32 margins, n_missing u32 chunk indices, and the crc
_RESPONSE_HEAD = struct.Struct("<4sHHIIIIfIIII")

FRAME_HEADER_BYTES = WA.FRAME_HEADER_BYTES
# the agg header sizes delegate to core.wire_accounting (the one wire-byte
# definition); a drifting struct layout fails loudly at import
assert _HEADER.size + 4 == WA.FRAME_HEADER_BYTES
assert _RESPONSE_HEAD.size == WA.RESPONSE_HEAD_BYTES

# response statuses
STATUS_QUEUED = 0     # payload buffered; verdict at the next drain
STATUS_ACK = 1        # payload decoded and accumulated
STATUS_NACK = 2       # decode failure detected: retry at (attempt+1, q_next)
STATUS_REJECT = 3     # malformed/mismatched payload: not retryable as-is
STATUS_RESEND = 4     # reassembly incomplete: retransmit the missing chunks
STATUS_RETRY = 5      # NON-terminal "not now": the round is sealed to new
                      # clients, the pending store is full, or the frame's
                      # round is no longer (or not yet) live.  round_id
                      # echoes the offending frame's round so the sender's
                      # protocol object sees it; q_next carries the round id
                      # currently open for admission (0 = unknown) — re-send
                      # after backoff, or re-enroll there.  The response
                      # wire format is unchanged from v3; the status value
                      # is additive.


class WireError(ValueError):
    """Base class for payload parse/validation failures."""


class TruncatedPayloadError(WireError):
    pass


class BadMagicError(WireError):
    pass


class VersionMismatchError(WireError):
    pass


class CorruptPayloadError(WireError):
    pass


class HeaderMismatchError(WireError):
    """Frame is well-formed but does not match the round's spec."""


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """Static per-round protocol contract (distributed out of band).

    The lattice granularity of the round is pinned per bucket by
    (y_buckets, cfg.q): s_b = 2*y_b/(cfg.q - 1) (uniformly y0 when
    ``y_buckets`` is None).  Escalation squares q with the sides fixed, so
    the attempt-a decode margin per bucket is y_a,b = s_b*(q_a - 1)/2.

    v3 addition: ``mtu`` — the round's chunk size in bytes.  0 keeps the
    single-frame protocol; a positive MTU makes every client split its
    payload body into ceil(body/mtu) independently-framed chunks (the
    transport chunk layer), and the server reassembles them out of order.
    The MTU is part of the contract so chunk geometry is checkable from any
    one frame (offset = chunk_index * mtu).

    v5 addition: ``window`` — the credit-based send window, in chunks.  0
    keeps the v4 blast-all-chunks behaviour; a positive window caps every
    client at ``window`` chunks in flight (sent but not covered by the
    server's cumulative ack) and switches the server to the streaming
    drain: validated contiguous chunk runs are residual-folded into the
    round sum as they land and their bytes freed, instead of being staged
    until the payload-CRC seal.  The published mean is bit-identical either
    way; the window only bounds sender burstiness and server pending-store
    memory.

    v2 carried ``y_buckets`` (per-bucket distance bounds from the previous
    round's telemetry) and ``anchor_digest`` (CRC-32 of the round anchor —
    round k-1's published mean; 0 = unanchored).  Clients encode
    ``x - anchor`` and the server REJECTs payloads whose digest does not
    match (stale-anchor clients are not silently mis-decoded).
    """
    round_id: int
    d: int
    cfg: QSyncConfig = QSyncConfig()
    y0: float = 1.0
    seed: int = 0
    # defaulting to the collectives' shared diagonal seed keeps the agg
    # bucket pipeline bit-identical to the star collective
    rot_seed: int = _ROTATION_SEED
    max_attempts: int = 4
    y_buckets: "tuple[float, ...] | None" = None
    anchor_digest: int = 0
    mtu: int = 0
    window: int = 0

    def __post_init__(self):
        if self.y_buckets is not None and len(self.y_buckets) != self.nb:
            raise ValueError(
                f"y_buckets has {len(self.y_buckets)} entries for "
                f"{self.nb} buckets")
        if self.mtu != 0 and self.mtu < 64:
            raise ValueError(f"mtu must be 0 (unchunked) or >= 64 bytes, "
                             f"got {self.mtu}")
        if self.window < 0:
            raise ValueError(f"window must be >= 0 chunks, "
                             f"got {self.window}")
        if self.window > 0 and self.mtu == 0:
            raise ValueError("window > 0 needs a chunked round (mtu > 0): "
                             "credit is granted per chunk")

    @property
    def padded(self) -> int:
        return flat_size_padded(self.d, self.cfg)

    @property
    def nb(self) -> int:
        return self.padded // self.cfg.bucket

    @property
    def anchored(self) -> bool:
        return self.anchor_digest != 0

    @property
    def side(self) -> float:
        """The uniform lattice side s0 (granularity never escalates).  With
        per-bucket bounds this is the *largest* side (y0 is kept as the
        uniform summary; sides_np() is the authoritative per-bucket array).
        """
        return 2.0 * self.y0 / (self.cfg.q - 1)

    def y_np(self) -> np.ndarray:
        """(nb,) f32 per-bucket distance bounds of the round."""
        if self.y_buckets is None:
            return np.full((self.nb,), self.y0, np.float32)
        return np.asarray(self.y_buckets, np.float32)

    def sides_np(self) -> np.ndarray:
        """(nb,) f32 per-bucket lattice sides s_b = 2*y_b/(q-1)."""
        return (self.y_np() * np.float32(2.0 / (self.cfg.q - 1))
                ).astype(np.float32)

    def body_bytes(self, attempt: int = 0) -> int:
        """Packed-words + sides body size at an escalation level."""
        q = q_at_attempt(self.cfg.q, attempt)
        return WA.packed_body_bytes(self.padded, L.bits_for_q(q), self.nb)

    def n_chunks(self, attempt: int = 0) -> int:
        """Chunks per client payload at an escalation level."""
        return WA.n_chunks(self.body_bytes(attempt), self.mtu)


def q_at_attempt(q0: int, attempt: int) -> int:
    """RobustAgreement color-space schedule: q0^(2^attempt), capped at 2^16."""
    q = q0
    for _ in range(attempt):
        if q >= Q_CAP:
            return Q_CAP
        q = q * q
    return min(q, Q_CAP)


def y_at_attempt(spec: RoundSpec, attempt: int) -> float:
    """Largest decode margin at an escalation level: y_a = s0*(q_a - 1)/2
    (the scalar summary; per-bucket margins via y_buckets_at_attempt)."""
    return spec.side * (q_at_attempt(spec.cfg.q, attempt) - 1) / 2.0


def y_buckets_at_attempt(spec: RoundSpec, attempt: int) -> np.ndarray:
    """(nb,) per-bucket decode margins at an escalation level."""
    q = q_at_attempt(spec.cfg.q, attempt)
    return (spec.sides_np() * np.float32((q - 1) / 2.0)).astype(np.float32)


def payload_bytes(spec: RoundSpec, attempt: int = 0) -> int:
    """Exact on-the-wire size of one client payload at an attempt level:
    the packed body plus one frame header per chunk (core.wire_accounting
    is the authoritative arithmetic, cross-checked against ``len()`` of the
    actual frames in the tests)."""
    q = q_at_attempt(spec.cfg.q, attempt)
    return WA.agg_payload_bytes(spec.padded, L.bits_for_q(q), spec.nb,
                                spec.mtu)


@dataclasses.dataclass(frozen=True)
class FrameHeader:
    """Parsed v4 frame header (framing validated; chunk body separate)."""
    round_id: int
    client_id: int
    attempt: int
    q: int
    d: int
    bucket: int
    seed: int
    rot_seed: int
    n_words: int
    nb: int
    check: int
    anchor_digest: int
    n_chunks: int
    chunk_index: int
    payload_crc: int
    rotate: bool
    anchored: bool
    n_summed: int = 1          # additive client count (tree tiers > 1)

    @property
    def body_len(self) -> int:
        """Byte length of the FULL payload body this frame belongs to."""
        return 4 * self.n_words + 4 * self.nb


@dataclasses.dataclass(frozen=True)
class Payload:
    """Complete client payload (validated framing; numpy views of the body)."""
    round_id: int
    client_id: int
    attempt: int
    q: int
    d: int
    bucket: int
    seed: int
    rot_seed: int
    rotate: bool
    check: int
    words: np.ndarray          # (n_words,) uint32
    sides: np.ndarray          # (nb,) f32
    anchor_digest: int = 0
    anchored: bool = False
    n_summed: int = 1          # additive client count (tree tiers > 1)
    # True when the words were already residual-folded range-by-range as
    # the chunks landed (streaming drain): ``words`` is empty — the body
    # bytes are gone — and only the retained sides sidecar remains for the
    # spec check at completion.  Streamed payloads never enter the batched
    # pending store.
    streamed: bool = False

    @property
    def nb(self) -> int:
        return self.sides.shape[0]


@dataclasses.dataclass(frozen=True)
class Response:
    status: int
    round_id: int
    client_id: int
    attempt_next: int
    q_next: int
    y_next: float
    y_buckets: "tuple[float, ...]" = ()    # per-bucket margins (NACK/QUEUED)
    missing: "tuple[int, ...]" = ()        # chunk indices (STATUS_RESEND)
    ack: int = 0                           # cumulative contiguous chunks held
    credit: int = 0                        # chunks allowed in flight past ack


def _pack_header(h: FrameHeader) -> bytes:
    flags = (FLAG_ROTATE if h.rotate else 0) \
        | (FLAG_ANCHORED if h.anchored else 0)
    return _HEADER.pack(MAGIC_PAYLOAD, WIRE_VERSION, flags, h.round_id,
                        h.client_id, h.attempt, h.q, h.d, h.bucket, h.seed,
                        h.rot_seed, h.n_words, h.nb, h.check & 0xFFFFFFFF,
                        h.anchor_digest & 0xFFFFFFFF, h.n_chunks,
                        h.chunk_index, h.payload_crc & 0xFFFFFFFF,
                        h.n_summed)


def encode_frame(h: FrameHeader, chunk: bytes) -> bytes:
    """Serialize one chunk-carrying frame (header + CRC + chunk bytes)."""
    return encode_frames([h], chunk, [(0, len(chunk))])[0]


def encode_frames(hs: "list[FrameHeader]", body: bytes,
                  spans: "list[tuple[int, int]]") -> "list[bytes]":
    """Serialize the frames that carry ``body[off:off + ln]`` under
    ``hs[i]`` for the i-th ``(off, ln)`` of ``spans``: each the same bytes
    as ``encode_frame(hs[i], body[off:off + ln])``.  Every frame's CRC is
    taken first, over a view of the body, and then every frame is copied
    out, so one call is one ``frame.crc`` and one ``frame.copy`` span
    however many chunks it frames.  Counts the bytes hashed and copied
    (``frame_crc_bytes``, ``frame_copy_bytes``) when metrics are on."""
    heads = [_pack_header(h) for h in hs]
    rid, cid = hs[0].round_id, hs[0].client_id
    with _obs.span("frame.crc", round=rid, client=cid), \
            memoryview(body) as view:
        crcs = [zlib.crc32(view[off:off + ln], zlib.crc32(head))
                for head, (off, ln) in zip(heads, spans)]
    with _obs.span("frame.copy", round=rid, client=cid):
        # a frame of the whole body takes it as it is: no slice, no copy
        frames = [b"".join((head, struct.pack("<I", crc),
                            body if ln == len(body)
                            else body[off:off + ln]))
                  for head, crc, (off, ln) in zip(heads, crcs, spans)]
    if _obs.metrics_enabled():
        _obs.counter("frame_crc_bytes").inc(
            sum(len(head) + ln for head, (_, ln) in zip(heads, spans)))
        _obs.counter("frame_copy_bytes").inc(
            sum(len(f) for f in frames)
            + sum(ln for _, ln in spans if ln != len(body)))
    return frames


_PEEK = struct.Struct("<4sHHII")      # magic | version | flags | round | cid


def peek_route(data: bytes) -> "tuple[int, int] | None":
    """Cheap (round_id, client_id) peek for event-loop routing — no CRC.

    Returns None when the prefix cannot even be a v3 frame (short / bad
    magic / wrong version); the caller then falls through to the full
    decoder, which produces the proper wire REJECT.  A corrupted-but-
    plausible round_id merely routes the frame to a server that will fail
    its CRC — routing never needs to be trusted, only cheap.
    """
    if len(data) < _PEEK.size:
        return None
    magic, version, _, round_id, client_id = _PEEK.unpack_from(data, 0)
    if magic != MAGIC_PAYLOAD or version != WIRE_VERSION:
        return None
    return round_id, client_id


def decode_frame(data: bytes) -> "tuple[FrameHeader, bytes]":
    """Parse + integrity-check one frame; raises WireError subclasses.

    Validates everything checkable from the frame alone: magic, version,
    per-frame CRC, header self-consistency (lattice geometry, flag/digest
    agreement, chunk coordinates), and — for single-frame payloads, whose
    body is fully present — the body length and payload CRC.  Chunk length
    against the round's MTU is the spec's business
    (:func:`check_frame_against_spec`).
    """
    try:
        return _decode_frame(data)
    except WireError as e:
        _count_decode_error("frame", e)
        raise


def _count_decode_error(path: str, e: WireError) -> None:
    if _obs.metrics_enabled():
        _obs.counter("wire_decode_errors", path=path,
                     kind=type(e).__name__).inc()


def _decode_frame(data: bytes) -> "tuple[FrameHeader, bytes]":
    hsize = _HEADER.size + 4                       # header + crc word
    if len(data) < hsize:
        raise TruncatedPayloadError(
            f"frame of {len(data)} bytes is shorter than the "
            f"{hsize}-byte header")
    (magic, version, flags, round_id, client_id, attempt, q, d, bucket,
     seed, rot_seed, n_words, nb, check, anchor_digest, n_chunks,
     chunk_index, payload_crc, n_summed) = _HEADER.unpack_from(data, 0)
    if magic != MAGIC_PAYLOAD:
        raise BadMagicError(f"bad magic {magic!r}")
    if version != WIRE_VERSION:
        raise VersionMismatchError(
            f"wire version {version} != supported {WIRE_VERSION}")
    (crc,) = struct.unpack_from("<I", data, _HEADER.size)
    chunk = data[hsize:]
    # header self-consistency (cheap sanity; spec matching is the server's)
    if q < 2 or q > Q_CAP or bucket < 1 or (bucket & (bucket - 1)):
        raise CorruptPayloadError(f"inconsistent header: q={q} "
                                  f"bucket={bucket}")
    padded = nb * bucket
    if d > padded or padded - d >= bucket:
        raise CorruptPayloadError(
            f"inconsistent header: d={d} vs nb*bucket={padded}")
    if n_words != L.packed_len(padded, L.bits_for_q(q)):
        raise CorruptPayloadError(
            f"inconsistent header: {n_words} words for {padded} coords "
            f"at q={q}")
    anchored = bool(flags & FLAG_ANCHORED)
    if anchored != (anchor_digest != 0):
        raise CorruptPayloadError(
            f"inconsistent header: anchored flag {anchored} vs "
            f"digest {anchor_digest}")
    body_len = 4 * n_words + 4 * nb
    if n_chunks < 1 or chunk_index >= n_chunks:
        raise CorruptPayloadError(
            f"inconsistent header: chunk {chunk_index} of {n_chunks}")
    if n_summed < 1:
        raise CorruptPayloadError(
            f"inconsistent header: n_summed={n_summed} (must be >= 1)")
    if n_chunks == 1 and len(chunk) < body_len:
        raise TruncatedPayloadError(
            f"body has {len(chunk)} bytes, header promises {body_len}")
    if len(chunk) == 0 or len(chunk) > body_len:
        raise CorruptPayloadError(
            f"chunk has {len(chunk)} bytes for a {body_len}-byte body")
    if zlib.crc32(chunk, zlib.crc32(data[:_HEADER.size])) != crc:
        raise CorruptPayloadError("frame CRC mismatch")
    if n_chunks == 1 and zlib.crc32(chunk) != payload_crc:
        raise CorruptPayloadError("payload CRC mismatch")
    h = FrameHeader(round_id=round_id, client_id=client_id, attempt=attempt,
                    q=q, d=d, bucket=bucket, seed=seed, rot_seed=rot_seed,
                    n_words=n_words, nb=nb, check=check,
                    anchor_digest=anchor_digest, n_chunks=n_chunks,
                    chunk_index=chunk_index, payload_crc=payload_crc,
                    rotate=bool(flags & FLAG_ROTATE), anchored=anchored,
                    n_summed=n_summed)
    return h, chunk


def payload_from_body(h: FrameHeader, body) -> Payload:
    """Assemble the Payload view over a complete (reassembled) body."""
    words = np.frombuffer(body, dtype="<u4", count=h.n_words)
    sides = np.frombuffer(body, dtype="<f4", offset=4 * h.n_words,
                          count=h.nb)
    return Payload(round_id=h.round_id, client_id=h.client_id,
                   attempt=h.attempt, q=h.q, d=h.d, bucket=h.bucket,
                   seed=h.seed, rot_seed=h.rot_seed, rotate=h.rotate,
                   check=h.check, words=words, sides=sides,
                   anchor_digest=h.anchor_digest, anchored=h.anchored,
                   n_summed=h.n_summed)


def streamed_payload(h: FrameHeader, sides_bytes: bytes) -> Payload:
    """Assemble the words-free Payload of a stream whose word ranges were
    already folded incrementally (the streaming drain's completion record:
    header identity + the retained sides sidecar)."""
    sides = np.frombuffer(sides_bytes, dtype="<f4", count=h.nb)
    return Payload(round_id=h.round_id, client_id=h.client_id,
                   attempt=h.attempt, q=h.q, d=h.d, bucket=h.bucket,
                   seed=h.seed, rot_seed=h.rot_seed, rotate=h.rotate,
                   check=h.check, words=np.empty((0,), np.uint32),
                   sides=sides, anchor_digest=h.anchor_digest,
                   anchored=h.anchored, n_summed=h.n_summed, streamed=True)


def build_payload(spec: RoundSpec, client_id: int, attempt: int, q: int,
                  words: np.ndarray, sides: np.ndarray, check: int,
                  n_summed: int = 1) -> "tuple[FrameHeader, bytes]":
    """Assemble (header, body) of one client message — the ONE place the
    payload-level header fields are filled in (the chunk layer re-derives
    only the chunk coordinates, so the chunked and unchunked encoders can
    never desync).  ``n_summed`` > 1 marks a tree tier's combined payload
    (the additive client count it folded in)."""
    if n_summed < 1:
        raise ValueError(f"n_summed must be >= 1, got {n_summed}")
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    sides = np.ascontiguousarray(np.asarray(sides, dtype=np.float32))
    with _obs.span("frame.copy", round=spec.round_id, client=client_id):
        body = words.tobytes() + sides.tobytes()
    with _obs.span("frame.crc", round=spec.round_id, client=client_id):
        pcrc = zlib.crc32(body)
    if _obs.metrics_enabled():
        # tobytes() copies the body once, the concatenation once more
        _obs.counter("frame_body_bytes").inc(len(body))
        _obs.counter("frame_copy_bytes").inc(2 * len(body))
        _obs.counter("frame_crc_bytes").inc(len(body))
    h = FrameHeader(round_id=spec.round_id, client_id=client_id,
                    attempt=attempt, q=q, d=spec.d, bucket=spec.cfg.bucket,
                    seed=spec.seed, rot_seed=spec.rot_seed,
                    n_words=words.shape[0], nb=sides.shape[0],
                    check=int(check) & 0xFFFFFFFF,
                    anchor_digest=spec.anchor_digest & 0xFFFFFFFF,
                    n_chunks=1, chunk_index=0, payload_crc=pcrc,
                    rotate=spec.cfg.rotate, anchored=spec.anchored,
                    n_summed=int(n_summed))
    return h, body


def encode_payload(spec: RoundSpec, client_id: int, attempt: int, q: int,
                   words: np.ndarray, sides: np.ndarray, check: int) -> bytes:
    """Serialize one client message as a SINGLE frame (the unchunked path;
    the chunk layer splits bigger-than-MTU bodies into many frames)."""
    h, body = build_payload(spec, client_id, attempt, q, words, sides, check)
    return encode_frame(h, body)


def decode_payload(data: bytes) -> Payload:
    """Parse + integrity-check a complete single-frame payload."""
    h, body = decode_frame(data)
    if h.n_chunks != 1:
        raise CorruptPayloadError(
            f"multi-chunk frame ({h.chunk_index}/{h.n_chunks}) where a "
            f"complete payload was expected")
    return payload_from_body(h, body)


def _spec_mismatches(round_id, attempt, q, d, bucket, seed, rot_seed,
                     rotate, anchor_digest, spec: RoundSpec) -> "list[str]":
    if round_id != spec.round_id:
        raise HeaderMismatchError(
            f"round {round_id} != current {spec.round_id}")
    want_q = q_at_attempt(spec.cfg.q, attempt)
    mism = [
        f"{k}: got {got}, want {want}" for k, got, want in (
            ("d", d, spec.d),
            ("bucket", bucket, spec.cfg.bucket),
            ("rotate", rotate, spec.cfg.rotate),
            ("seed", seed, spec.seed),
            ("rot_seed", rot_seed, spec.rot_seed),
            ("q", q, want_q),
        ) if got != want]
    if attempt >= spec.max_attempts:
        mism.append(f"attempt {attempt} >= max {spec.max_attempts}")
    # anchor agreement: a client that encoded against a stale/foreign anchor
    # produced coordinates on a shifted lattice — its checksum is self-
    # consistent, so only the digest stops it from corrupting the mean
    if anchor_digest != (spec.anchor_digest & 0xFFFFFFFF):
        mism.append(f"anchor digest {anchor_digest:#x} != round "
                    f"{spec.anchor_digest:#x}")
    return mism


def check_frame_against_spec(h: FrameHeader, spec: RoundSpec,
                             chunk_len: int) -> None:
    """Raise HeaderMismatchError when a frame doesn't belong to a round.

    Runs per chunk, before any reassembly state is touched — a cross-round
    stale chunk, a foreign-config chunk, or a chunk whose geometry violates
    the round's MTU contract never enters a session.
    """
    mism = _spec_mismatches(h.round_id, h.attempt, h.q, h.d, h.bucket,
                            h.seed, h.rot_seed, h.rotate, h.anchor_digest,
                            spec)
    want_chunks = WA.n_chunks(h.body_len, spec.mtu)
    if h.n_chunks != want_chunks:
        mism.append(f"n_chunks {h.n_chunks} != {want_chunks} for a "
                    f"{h.body_len}-byte body at mtu {spec.mtu}")
    elif h.n_chunks > 1:
        _, want_len = WA.chunk_span(h.body_len, spec.mtu, h.chunk_index)
        if chunk_len != want_len:
            mism.append(f"chunk {h.chunk_index} has {chunk_len} bytes, "
                        f"mtu geometry wants {want_len}")
    if mism:
        raise HeaderMismatchError("; ".join(mism))


def check_sides_against_spec(p: Payload, spec: RoundSpec) -> None:
    """The body-level spec check: the sides sidecar must carry the round's
    pinned per-bucket granularity — a client built against different bounds
    would otherwise be accepted (its checksum is self-consistent) yet
    scaled by the *round's* sides at finalize, silently corrupting the
    mean.  This is the ONLY check the header-level
    :func:`check_frame_against_spec` (already run once per frame) cannot
    do, so it is all the server re-runs at payload completion."""
    if not np.array_equal(p.sides, spec.sides_np()):
        raise HeaderMismatchError(
            "sides sidecar != round per-bucket sides (y mismatch)")


def check_against_spec(p: Payload, spec: RoundSpec) -> None:
    """Raise HeaderMismatchError when a complete payload doesn't belong to
    a round: every header-level check plus the sides sidecar."""
    mism = _spec_mismatches(p.round_id, p.attempt, p.q, p.d, p.bucket,
                            p.seed, p.rot_seed, p.rotate, p.anchor_digest,
                            spec)
    if not np.array_equal(p.sides, spec.sides_np()):
        mism.append("sides sidecar != round per-bucket sides (y mismatch)")
    if mism:
        raise HeaderMismatchError("; ".join(mism))


def encode_response(r: Response) -> bytes:
    yb = np.asarray(r.y_buckets, np.float32)
    miss = np.asarray(r.missing, np.uint32)
    head0 = _RESPONSE_HEAD.pack(MAGIC_RESPONSE, WIRE_VERSION, r.status,
                                r.round_id, r.client_id, r.attempt_next,
                                r.q_next, r.y_next, yb.shape[0],
                                miss.shape[0], r.ack, r.credit)
    body = head0 + yb.tobytes() + miss.tobytes()
    return body + struct.pack("<I", zlib.crc32(body))


def decode_response(data: bytes) -> Response:
    try:
        return _decode_response(data)
    except WireError as e:
        _count_decode_error("response", e)
        raise


def _decode_response(data: bytes) -> Response:
    hsize = _RESPONSE_HEAD.size
    if len(data) < hsize + 4:
        raise TruncatedPayloadError(
            f"response of {len(data)} bytes < {hsize + 4}")
    (magic, version, status, round_id, client_id, attempt_next, q_next,
     y_next, nb, n_missing, ack, credit) = _RESPONSE_HEAD.unpack_from(data, 0)
    if magic != MAGIC_RESPONSE:
        raise BadMagicError(f"bad magic {magic!r}")
    if version != WIRE_VERSION:
        raise VersionMismatchError(
            f"wire version {version} != supported {WIRE_VERSION}")
    want = hsize + 4 * nb + 4 * n_missing + 4
    if len(data) != want:
        raise CorruptPayloadError(
            f"response has {len(data)} bytes, header promises {want}")
    (crc,) = struct.unpack_from("<I", data, want - 4)
    if zlib.crc32(data[:want - 4]) != crc:
        raise CorruptPayloadError("response CRC mismatch")
    yb = np.frombuffer(data, dtype="<f4", offset=hsize, count=nb)
    miss = np.frombuffer(data, dtype="<u4", offset=hsize + 4 * nb,
                         count=n_missing)
    return Response(status=status, round_id=round_id, client_id=client_id,
                    attempt_next=attempt_next, q_next=q_next, y_next=y_next,
                    y_buckets=tuple(float(v) for v in yb),
                    missing=tuple(int(v) for v in miss),
                    ack=ack, credit=credit)
