"""The one wire-byte arithmetic for the whole repo.

Every layer that moves (or accounts for) the paper's packed lattice payload
used to carry its own copy of the byte math: the quantized collectives
(``dist/collectives._payload_bytes`` and the per-topology ``wire_bytes_*``),
the FSDP gradient sync (``dist/fsdp.wire_bytes_bwd``), and the aggregation
protocol's header constants (``agg/transport/frame``).  This module is the
single definition they all delegate to; the tests cross-check it against the
``len()`` of actual payload bytes and the actual collective transfer shapes.

Three vocabularies, one body format:

* **body bytes** — the packed payload itself: ``ceil(n/per)`` uint32 words of
  ``bits``-bit mod-q colors (``per = 32 // bits`` colors per word, see
  :func:`repro_torch.core.lattice.packed_len`) plus one f32 lattice side per
  bucket (the sides sidecar).  The unpacked debugging path moves raw uint32
  color buffers instead (4 bytes/coordinate, no sidecar).
* **collective bytes** — bytes *sent per rank* by a topology: recursive
  doubling (butterfly) sends ``log2(world)`` full payloads, the ring
  all-gather forwards ``world - 1`` payloads, recursive halving sends a
  halving sequence of segment payloads, and the fp32 ring reduce-scatter
  moves ``(world-1)/world`` of the segment per axis.
* **framed bytes** — the aggregation service's on-the-wire cost: each
  transport frame (``agg/transport/frame``) prepends a fixed
  :data:`FRAME_HEADER_BYTES` header, and a body larger than the round's MTU
  is split into :func:`n_chunks` independently-framed chunks (the chunk
  layer), so one client payload costs ``n_chunks * FRAME_HEADER_BYTES +
  body`` bytes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import lattice as L

# one f32 lattice side per bucket rides along with the packed words
SIDE_BYTES = 4
WORD_BYTES = 4

# agg transport frame layout (v5; unchanged since v4), see
# repro_torch.agg.transport.frame:
#   magic 4s | version u16 | flags u16 | 16 x u32 fields | crc u32
# The frame module asserts its struct sizes against these at import time —
# the constants live here so the header math is auditable next to the body
# math it frames.
FRAME_FIXED_FIELDS = 16
FRAME_HEADER_BYTES = 4 + 2 + 2 + 4 * FRAME_FIXED_FIELDS + 4        # 76
# response head: magic 4s | version u16 | status u16 | 4 x u32 | f32 | 2 x u32
# | ack u32 | credit u32 (the v5 additive flow-control fields: cumulative
# contiguous-chunk ack + send-window credit)
RESPONSE_HEAD_BYTES = 4 + 2 + 2 + 4 * 4 + 4 + 4 * 2 + 4 * 2        # 44
RESPONSE_CRC_BYTES = 4


# ---------------------------------------------------------------------------
# Body bytes (one full-vector message, no framing)
# ---------------------------------------------------------------------------

def packed_words_bytes(n: int, bits: int) -> int:
    """Bytes of the packed color words for n coordinates at ``bits`` each."""
    return WORD_BYTES * L.packed_len(n, bits)


def sides_bytes(nb: int) -> int:
    """Bytes of the f32 sides sidecar for ``nb`` buckets."""
    return SIDE_BYTES * nb


def packed_body_bytes(padded: int, bits: int, nb: int) -> int:
    """Packed words + sides sidecar: the payload body every layer moves."""
    return packed_words_bytes(padded, bits) + sides_bytes(nb)


def unpacked_body_bytes(padded: int) -> int:
    """The unpacked fallback's raw uint32 color buffer (no sidecar)."""
    return 4 * padded


def collective_payload_bytes(padded: int, bits: int, nb: int,
                             packed: bool = True) -> int:
    """One full-vector collective message (packed or the unpacked oracle)."""
    if not packed:
        return unpacked_body_bytes(padded)
    return packed_body_bytes(padded, bits, nb)


# ---------------------------------------------------------------------------
# Collective bytes (per-topology, bytes sent per rank)
# ---------------------------------------------------------------------------

def _log2_rounds(world: int) -> int:
    return max(int(np.log2(world)), 0) if world > 1 else 0


def butterfly_bytes(padded: int, bits: int, nb: int, world: int,
                    packed: bool = True) -> int:
    """Recursive doubling: log2(world) rounds, one full payload each."""
    return _log2_rounds(world) * collective_payload_bytes(padded, bits, nb,
                                                          packed)


def allgather_bytes(padded: int, bits: int, nb: int, world: int,
                    packed: bool = True) -> int:
    """Ring all-gather of every rank's payload: world-1 forwarded chunks."""
    return max(world - 1, 0) * collective_payload_bytes(padded, bits, nb,
                                                        packed)


def rh_bytes(padded: int, bits: int, nb: int, world: int,
             packed: bool = True) -> int:
    """Recursive halving: round r sends the (padded/2^{r+1})-coordinate half
    of the working segment (packed: its words + its share of the sides
    sidecar; unpacked: the raw color buffer); the payload halves every
    round, summing to ~one full payload."""
    total = 0
    for r in range(_log2_rounds(world)):
        seg, seg_nb = padded >> (r + 1), nb >> (r + 1)
        total += collective_payload_bytes(seg, bits, seg_nb, packed)
    return total


def fp32_ring_reduce_scatter_bytes(seg: int, world: int) -> int:
    """Ring psum_scatter of an f32 segment: (world-1)/world of it moves."""
    return 4 * (seg - seg // world)


def anchor_gather_bytes(m: int, world: int) -> int:
    """Per-rank wire bytes of rebuilding a *sharded* anchor by tiled f32
    ring all-gather: (world-1)/world of the (m,) vector.  This rides the
    FSDP forward weight-gather slot (dist/fsdp.py), so it overlaps compute
    under prefetch rather than serializing the backward sync."""
    w = max(world, 1)
    return 4 * (m - m // w)


def anchor_state_bytes(m: int, world: int, sharded: bool) -> int:
    """Per-rank bytes of next-step anchor state one anchored gradient sync
    materializes *beyond the rank's own ZeRO-3 shard* of the (m,) mean.

    Legacy replicated anchors write the full f32 vector into every rank's
    telemetry — ``4 * (m - m/world)`` bytes beyond the shard the rank
    would keep anyway.  Sharded anchors (``FSDPConfig.anchor_sharded``)
    write only the rank's own ``(m/world,)`` slice: zero extra.  Either
    way the backward *wire* cost is unchanged (``fsdp.wire_bytes_bwd``) —
    the butterfly's common output doubles as the anchor, and the sharded
    anchor's rebuild is :func:`anchor_gather_bytes` on the forward."""
    if sharded:
        return 0
    w = max(world, 1)
    return 4 * (m - m // w)


# ---------------------------------------------------------------------------
# Framed bytes (the agg transport stack: frame + chunk layers)
# ---------------------------------------------------------------------------

def n_chunks(body_len: int, mtu: int) -> int:
    """Chunk count for a body under an MTU (0 = unchunked single frame)."""
    if mtu <= 0 or body_len <= mtu:
        return 1
    return -(-body_len // mtu)


def chunk_span(body_len: int, mtu: int, index: int) -> "tuple[int, int]":
    """(offset, length) of chunk ``index`` in the body.  Every chunk except
    the last carries exactly ``mtu`` bytes, so a receiver can place any
    chunk at ``index * mtu`` without seeing the others first."""
    nc = n_chunks(body_len, mtu)
    if not 0 <= index < nc:
        raise ValueError(f"chunk {index} out of range for {nc} chunks")
    if nc == 1:
        return 0, body_len
    off = index * mtu
    return off, min(mtu, body_len - off)


def frame_bytes(chunk_len: int) -> int:
    """On-the-wire size of one transport frame carrying ``chunk_len`` body
    bytes (fixed v4 header + per-frame CRC included in the header size)."""
    return FRAME_HEADER_BYTES + chunk_len


def framed_payload_bytes(body_len: int, mtu: int) -> int:
    """Total wire bytes to deliver one payload body under an MTU: every
    chunk repeats the self-describing frame header."""
    return n_chunks(body_len, mtu) * FRAME_HEADER_BYTES + body_len


def chunk_overhead_pct(body_len: int, mtu: int) -> float:
    """Extra header bytes of chunking as a percentage of the single-frame
    wire size (0.0 when the body fits one frame)."""
    single = frame_bytes(body_len)
    return 100.0 * (framed_payload_bytes(body_len, mtu) - single) / single


def agg_payload_bytes(padded: int, bits: int, nb: int, mtu: int = 0) -> int:
    """Exact wire bytes of one aggregation-protocol client payload: the
    packed body framed (and, under an MTU, chunked) by the transport."""
    return framed_payload_bytes(packed_body_bytes(padded, bits, nb), mtu)
