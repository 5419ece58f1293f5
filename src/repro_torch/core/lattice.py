"""Cubic-lattice quantization (paper §3, §6, §9.1); counterpart of
``repro.core.lattice``.

* The lattice is the scaled cubic lattice ``s·Z^d``, offset by a shared
  random shift ``u·s`` with ``u ~ U[-1/2, 1/2)^d``.
* Encoding ``x``: lattice coordinates ``k = round(x/s - u)`` (half to
  even), transmitted as the color ``c = k mod q``.
* Decoding against an anchor ``a``: the lattice point with color ``c``
  nearest to ``a``::

      k_a   = round(a/s - u)
      k_hat = k_a + centered_mod(c - k_a, q)
      z     = (k_hat + u) * s

Everything here is plain torch on whatever device the tensors live on.
Colors are int32 (they are < 2^16), and packed uint32 words are carried as
int32 bit views because torch has no unsigned 32-bit arithmetic.  The fused
CUDA kernels in :mod:`repro_torch.kernels` compute the same functions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import random as _random

# Supported color bit-widths for packing (colors per uint32 word).
PACK_BITS = (1, 2, 4, 8, 16)
_M32 = 0xFFFFFFFF


def bits_for_q(q: int) -> int:
    """Bits per coordinate for q color classes, rounded up to a packable width."""
    raw = max(1, int(np.ceil(np.log2(q))))
    for b in PACK_BITS:
        if b >= raw:
            return b
    raise ValueError(f"q={q} needs {raw} bits/coord; max supported is 16")


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Static parameters of a cubic-lattice quantizer: ``q`` color classes,
    side ``s = 2*y/(q-1)`` for distance bound ``y`` (paper §9.1)."""

    q: int

    def __post_init__(self):
        if self.q < 2:
            raise ValueError("q must be >= 2")

    @property
    def bits(self) -> int:
        return bits_for_q(self.q)

    def side(self, y) -> torch.Tensor:
        """Lattice side length s for distance bound y (paper: s = 2y/(q-1))."""
        return torch.as_tensor(y, dtype=torch.float32) * (2.0 / (self.q - 1))

    def wire_bits(self, d: int) -> int:
        """Payload bits for a d-dim vector (excl. the O(1) scalar y)."""
        return d * self.bits


def shared_offset(key, shape, *, device=None) -> torch.Tensor:
    """Shared-randomness lattice offset u ~ U[-1/2, 1/2)^d (paper §9.1)."""
    return _random.uniform(key, shape, -0.5, 0.5, device=device)


def encode_coords(x: torch.Tensor, s, u: Optional[torch.Tensor] = None,
                  *, key=None) -> torch.Tensor:
    """Integer lattice coordinates of x, unbiasedly: ``round(x/s - u)``
    with a shared offset ``u`` (dithered); else, with ``key``, stochastic
    rounding ``floor(x/s) + (frac > r)`` with ``r = uniform(key, x.shape)``
    drawn on x's device; with neither, plain nearest rounding (biased)."""
    t = x.to(torch.float32) / torch.as_tensor(s, dtype=torch.float32,
                                              device=x.device)
    if u is not None:
        t = t - u
    elif key is not None:
        r = _random.uniform(key, tuple(x.shape), device=x.device)
        lo = torch.floor(t)
        return (lo + ((t - lo) > r)).to(torch.int32)
    return torch.round(t).to(torch.int32)


def color_of(k: torch.Tensor, q: int) -> torch.Tensor:
    """Mod-q color class of integer lattice coordinates (paper §3.1)."""
    return torch.remainder(k, q).to(torch.int32)


def centered_mod(delta: torch.Tensor, q: int) -> torch.Tensor:
    """Map integers to the representative in [-q/2, q/2) of their mod-q class."""
    half = q // 2
    return torch.remainder(delta + half, q) - half


def decode_coords(colors: torch.Tensor, anchor: torch.Tensor, s,
                  u: Optional[torch.Tensor] = None, *, q: int) -> torch.Tensor:
    """Nearest lattice point to ``anchor`` whose color matches (paper Alg. 2)."""
    t = anchor.to(torch.float32) / torch.as_tensor(
        s, dtype=torch.float32, device=anchor.device)
    if u is not None:
        t = t - u
    k_a = torch.round(t).to(torch.int32)
    delta = centered_mod(colors.to(torch.int32) - k_a, q)
    return k_a + delta


def coords_to_point(k: torch.Tensor, s, u: Optional[torch.Tensor] = None,
                    dtype=torch.float32) -> torch.Tensor:
    t = k.to(torch.float32)
    if u is not None:
        t = t + u
    return (t * torch.as_tensor(s, dtype=torch.float32, device=k.device)
            ).to(dtype)


# ---------------------------------------------------------------------------
# One-call encode/decode API (unpacked colors; packing lives in kernels/)
# ---------------------------------------------------------------------------

def lattice_encode(x: torch.Tensor, y, spec: LatticeSpec, key=None,
                   u: Optional[torch.Tensor] = None):
    """Encode x given distance bound y.  Returns (colors int32, side s).

    With ``u`` the shared offset dithers; else with ``key`` the rounding
    is stochastic (``uniform`` draws on x's device); else it is nearest."""
    s = spec.side(y)
    return color_of(encode_coords(x, s, u, key=key), spec.q), s


def lattice_decode(colors: torch.Tensor, anchor: torch.Tensor, y,
                   spec: LatticeSpec, u: Optional[torch.Tensor] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """Decode colors against the receiver's anchor vector."""
    s = spec.side(y)
    k = decode_coords(colors, anchor, s, u, q=spec.q)
    return coords_to_point(k, s, u, dtype)


def decode_failure(z: torch.Tensor, anchor: torch.Tensor, y) -> torch.Tensor:
    """Error-detection surrogate (paper §5): True when any decoded
    coordinate lies farther than ``1.5 y`` from the anchor, i.e. the mod-q
    class wrapped.  Returns a 0-d bool tensor."""
    yv = torch.as_tensor(y, dtype=torch.float32, device=z.device)
    return torch.any((z.to(torch.float32) - anchor.to(torch.float32)).abs()
                     > 1.5 * yv)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` for f32 tensors, rounded once to f32, as a fused
    multiply-add rounds it.  The reference's compiler (XLA on the CPU)
    contracts such mul-adds where it fuses them, so the port rounds them
    once where the reference's programs do.

    The f64 product of two f32s is exact.  The f64 sum is not when the
    addends lie far apart, and rounding it to nearest and then to f32
    could land on an f32 tie the exact sum misses.  So the sum is rounded
    to odd instead (its error from a two-sum decides), which 53 bits make
    safe to round again to f32's 24 (Boldo and Melquiond, 2008)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - cd
    err = (s - bp).neg_().add_(cd).add_(p - bp)   # s + err == a * b + c
    del p, cd, bp
    bits = s.view(torch.int64)
    # inexact with an even last bit: one ulp toward the exact sum
    step = torch.sign(err.mul_(s)).to(torch.int64).mul_((bits & 1) ^ 1)
    return bits.add_(step).view(torch.float64).to(torch.float32)


def fma_f32_abs_amax(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                     ) -> torch.Tensor:
    """``fma_f32(a, b, c).abs().amax(-1)`` at the cost of one f64 sum.

    Rounding is monotone, so the largest f64 sum of a row is the f64
    rounding of the row's largest exact one, and rounding it on to f32
    goes wrong only where it sits on an f32 tie.  Those rows (rare) are
    taken again through ``fma_f32``."""
    m = (a.double() * b.double() + c.double()).abs_().amax(-1)
    r = m.to(torch.float32)
    lo = r.double()
    other = torch.nextafter(
        r, torch.where(lo < m, float("inf"), float("-inf"))).double()
    tie = (lo + other) * 0.5 == m
    if bool(tie.any()):
        a, b, c = torch.broadcast_tensors(a, b, c)
        r[tie] = fma_f32(a[tie], b[tie], c[tie]).abs().amax(-1)
    return r


# ---------------------------------------------------------------------------
# Bit packing (plain torch; the CUDA encode kernel fuses this with encode)
# ---------------------------------------------------------------------------

def packed_len(n: int, bits: int) -> int:
    per = 32 // bits
    return (n + per - 1) // per


def pack_colors(colors: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack colors (< 2**bits) into 32-bit words, little-endian lanes.

    Returns the words as an int32 bit view."""
    if bits not in PACK_BITS:
        raise ValueError(f"bits={bits} not in {PACK_BITS}")
    per = 32 // bits
    n = colors.shape[-1]
    pad = (-n) % per
    c = torch.nn.functional.pad(colors.to(torch.int64), (0, pad))
    c = c.reshape(c.shape[:-1] + (c.shape[-1] // per, per))
    shifts = torch.arange(per, dtype=torch.int64, device=c.device) * bits
    # the fields are disjoint, so the sum is the bitwise OR
    return _random.as_int32_bits(torch.sum(c << shifts, dim=-1))


def unpack_colors(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Inverse of pack_colors; returns the first n colors as int32."""
    if bits not in PACK_BITS:
        raise ValueError(f"bits={bits} not in {PACK_BITS}")
    per = 32 // bits
    w = words.to(torch.int64) & _M32
    shifts = torch.arange(per, dtype=torch.int64, device=w.device) * bits
    c = (w[..., :, None] >> shifts) & ((1 << bits) - 1)
    c = c.reshape(words.shape[:-1] + (words.shape[-1] * per,))
    return c[..., :n].to(torch.int32)


def wire_bytes(n: int, bits: int) -> int:
    """Bytes on the wire for n coordinates at `bits` bits each (packed)."""
    return packed_len(n, bits) * 4
