"""Frozen copy of the threefry2x32 stream that a round's draws come from.

Copied from ``src/repro_torch/random.py`` (``_threefry2x32``, ``PRNGKey``,
``fold_in``, ``bits``, ``uniform``, ``rademacher`` and the chunked draw),
cut to what the reference client needs, and kept here so that the
benchmark's reference imports nothing of the program.  The stream is
``jax.random``'s in partitionable mode: element ``i`` of a draw under
``key`` is ``y0 ^ y1`` of ``threefry(key, (i >> 32, i & 0xFFFFFFFF))``.

A key is a pair of Python ints.  Draws run in plain torch int64 masked to
32 bits, on the device of the caller's choice, in chunks of ``CHUNK``
elements; ``span=(start, stop)`` draws elements ``start .. stop - 1`` of
the flat draw, bitwise the same slice of the whole.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
CHUNK = 1 << 24
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & M32


def threefry2x32(key, x0, x1):
    """The 20-round Threefry-2x32 hash of count pairs (x0, x1) under
    ``key``; works on Python ints and on int64 tensors alike."""
    k1, k2 = int(key[0]) & M32, int(key[1]) & M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x0 + ks[0]) & M32
    b = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + i + 1) & M32
    return a, b


def prng_key(seed: int):
    """The raw key of an integer seed: its low 32 bits behind a zero."""
    return (0, int(seed) & M32)


def fold_in(key, data: int):
    """A new key from ``key`` and a uint32 datum."""
    y0, y1 = threefry2x32(key, 0, int(data) & M32)
    return int(y0), int(y1)


def raw_bits(key, start: int, stop: int, device, fn, dtype):
    """``fn`` of the int64 uint32 bits of elements ``start .. stop - 1``,
    chunk by chunk, into a flat ``dtype`` tensor."""
    out = torch.empty(stop - start, dtype=dtype, device=device)
    for c0 in range(start, stop, CHUNK):
        c1 = min(stop, c0 + CHUNK)
        lo = torch.arange(c0, c1, dtype=torch.int64, device=device)
        y0, y1 = threefry2x32(key, torch.zeros_like(lo), lo)
        out[c0 - start:c1 - start] = fn(y0 ^ y1)
    return out


def int32_view(v):
    """int64 values in [0, 2^32) -> their int32 bit view."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def bits(key, span, device):
    """uint32 bits of a flat draw's ``span``, as an int32 bit view."""
    return raw_bits(key, span[0], span[1], device, int32_view, torch.int32)


def unit_floats(v):
    """uint32 bits -> f32 in [0, 1): 23 mantissa bits under 1.0, minus 1."""
    return ((v >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, span, minval: float, maxval: float, device):
    """f32 uniform draw in [minval, maxval) over ``span``: the unit float
    times the f32 width plus the f32 minimum, floored at the minimum."""
    lo = torch.tensor(minval, dtype=torch.float32)
    width = (torch.tensor(maxval, dtype=torch.float32) - lo).to(device)
    lo = lo.to(device)

    def fn(v):
        return torch.maximum(unit_floats(v) * width + lo, lo)
    return raw_bits(key, span[0], span[1], device, fn, torch.float32)


def rademacher(key, n: int, device):
    """f32 +-1 draw of n elements: +1 where the unit float is below 0.5."""
    def fn(v):
        return torch.where(unit_floats(v) < 0.5, 1.0, -1.0)
    return raw_bits(key, 0, n, device, fn, torch.float32)
