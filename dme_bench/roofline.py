"""The chip's peaks and the bytes each measured kernel must move.

Byte counts frozen from ``chip_smoke.py`` (``bound`` and the byte sums of
``encode_check``, ``batched_decode_check`` and ``fwht_check``): each input
read once and each output written once, at the call's shapes.  At the
smoke's width (277,848,064 padded coordinates, q = 16, bucket 4,096, 16
senders) they give the smoke's bounds: 1.0368275 ms for the encode with
coordinates, 6.6364736 ms for the batched decode and 0.6635178 ms for the
FWHT of f32 rows.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
PACK_BITS = (1, 2, 4, 8, 16)


def bits_for_q(q: int) -> int:
    """Bits a packed color takes for q colors: log2(q) rounded up to a
    width that divides 32."""
    raw = max(1, math.ceil(math.log2(q)))
    return next(b for b in PACK_BITS if b >= raw)


def bound_ms(nbytes: float) -> float:
    """The least milliseconds the chip's HBM takes to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def encode_bytes(n: int, bits: int, nb: int, coords: bool = True,
                 anchored: bool = False) -> float:
    """The fused encode of n padded coordinates: x, u (and the anchor)
    read, the packed words (and the int32 coordinates) written, the nb
    per-bucket sides read."""
    return n * (4 + 4 + (4 if anchored else 0) + bits / 8
                + (4 if coords else 0)) + nb * 4


def decode_batched_bytes(senders: int, n: int, bits: int, nb: int) -> float:
    """The batched decode into coordinates: every sender's words and int32
    coordinates, the anchor and u read once, every sender's sides."""
    return senders * n * (bits / 8 + 4) + n * 8 + senders * nb * 4


def fwht_bytes(n: int, itemsize: int = 4) -> float:
    """The FWHT of n coordinates: read once, written once."""
    return n * 2 * itemsize


def client_round_bytes(d: int, padded: int, bits: int) -> float:
    """The least a client's round must move: its gradient read once and
    its packed words written once."""
    return d * 4 + padded * bits / 8
