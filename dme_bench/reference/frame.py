"""Frozen copy of the aggregation protocol's client frame layout (v5).

Copied from ``src/repro_torch/agg/transport/frame.py`` (``_HEADER``,
``_pack_header``, ``build_payload``, ``encode_frame``) and
``src/repro_torch/core/wire_accounting.py`` (the header size), cut to the
single-frame payload of an unchunked round (MTU 0), so that the reference
builds a client's frame without the program.  Little-endian:

    magic b"DMEA" | version u16 (5) | flags u16 (bit 0 rotate, bit 1
    anchored) | round_id | client_id | attempt | q | d | bucket | seed |
    rot_seed | n_words | nb | check | anchor_digest | n_chunks |
    chunk_index | payload_crc | n_summed | crc (u32 each) | body

The body is the packed uint32 words then the f32 per-bucket sides;
``payload_crc`` is the CRC-32 of the body and ``crc`` that of the header
(up to ``crc``) followed by the body.
"""
from __future__ import annotations

import struct
import zlib

MAGIC = b"DMEA"
VERSION = 5
FLAG_ROTATE = 1
FLAG_ANCHORED = 2
HEADER = struct.Struct("<4sHH16I")
HEADER_BYTES = HEADER.size + 4           # 76, the CRC word included


def client_frame(*, round_id: int, client_id: int, q: int, d: int,
                 bucket: int, seed: int, rot_seed: int, rotate: bool,
                 check: int, words: bytes, sides: bytes) -> bytes:
    """One unchunked, unanchored client frame at attempt 0."""
    body = words + sides
    head = HEADER.pack(MAGIC, VERSION, FLAG_ROTATE if rotate else 0,
                       round_id, client_id, 0, q, d, bucket, seed, rot_seed,
                       len(words) // 4, len(sides) // 4, check & 0xFFFFFFFF,
                       0, 1, 0, zlib.crc32(body), 1)
    return head + struct.pack("<I", zlib.crc32(body, zlib.crc32(head))) + body
