"""Error detection in quantization (paper §5); counterpart of
``repro.core.error_detect``.

The payload keeps the cheap mod-q coloring and carries a 32-bit coordinate
checksum, an affine hash of the integer lattice coordinates under shared
randomness::

    h(k) = sum_i a_i * k_i  mod 2^32,   a_i ~ shared uniform odd uint32

A wrong proximity decode moves at least one k_i by a nonzero multiple of q,
so the checksum mismatches unless the weighted sum collides.

torch has no unsigned 32-bit arithmetic, so the weights are carried as
int32 bit views and the hash is taken in int64: each product ``k_i * a_i``
(|k_i| < 2^31, a_i < 2^32) fits, is reduced mod 2^32, and the sum of the
reduced terms is reduced again.  The columns are processed in chunks so
that the int64 temporaries stay bounded at any vector length.

``DetectingEncoder`` attaches the checksum to a lattice payload, and
``robust_agreement`` (paper Alg. 5, host-side reference) escalates
q <- q^2 until the receiver's checksum matches; expected bits follow
Lemma 23.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as _random
from repro_torch.core import lattice as L

_M32 = 0xFFFFFFFF
# int64 elements per checksum chunk (a few hundred MB of temporaries)
_CHUNK_ELEMS = 1 << 25


def checksum_weights(key, d: int, *, device=None) -> torch.Tensor:
    """Shared-randomness odd uint32 weights (int32 bit view), shape (d,)."""
    return _random.bits(key, (d,), device=device) | 1


def coord_checksum(k: torch.Tensor, weights: torch.Tensor,
                   axis=None) -> torch.Tensor:
    """h(k) = <a, k> mod 2^32, as an int64 tensor holding the uint32 value.

    ``axis=None`` hashes all of k (one message; k and weights both (n,));
    ``axis=-1`` hashes each row of a batch: k (S, n), weights (n,) -> (S,).
    """
    if axis is None:
        rows = k.reshape(1, -1)
        w = weights.reshape(-1)
    elif axis in (-1, k.dim() - 1):
        rows = k.reshape(-1, k.shape[-1])
        w = weights
    else:
        raise ValueError(f"axis must be None or -1, got {axis}")
    n = rows.shape[1]
    acc = torch.zeros(rows.shape[0], dtype=torch.int64, device=k.device)
    step = max(1, _CHUNK_ELEMS // max(1, rows.shape[0]))
    for c0 in range(0, n, step):
        kc = rows[:, c0:c0 + step].to(torch.int64)
        wc = w[c0:c0 + step].to(torch.int64) & _M32
        acc += ((kc * wc) & _M32).sum(dim=1)
    acc &= _M32
    if axis is None:
        return acc[0]
    return acc.reshape(k.shape[:-1])


@dataclasses.dataclass(frozen=True)
class DetectingEncoder:
    """Lattice encoder whose messages carry the §5-style detection checksum."""
    q: int = 16

    @property
    def spec(self) -> L.LatticeSpec:
        return L.LatticeSpec(self.q)

    def encode(self, x: torch.Tensor, y, weights: torch.Tensor, key=None,
               u: Optional[torch.Tensor] = None) -> dict:
        k = L.encode_coords(x, self.spec.side(y), u, key=key)
        return {
            "words": L.pack_colors(L.color_of(k, self.q), self.spec.bits),
            "check": coord_checksum(k, weights),
        }

    def decode(self, payload: dict, anchor: torch.Tensor, y,
               weights: torch.Tensor, u: Optional[torch.Tensor] = None):
        """Returns (z, ok).  ok=False <=> decode failure detected."""
        s = self.spec.side(y)
        colors = L.unpack_colors(payload["words"], anchor.shape[-1],
                                 self.spec.bits)
        k = L.decode_coords(colors, anchor, s, u, q=self.q)
        ok = coord_checksum(k, weights) == payload["check"]
        return L.coords_to_point(k, s, u, anchor.dtype), ok

    def wire_bits(self, d: int) -> int:
        return L.wire_bytes(d, self.spec.bits) * 8 + 32


def robust_agreement(x_u: torch.Tensor, x_v: torch.Tensor, y0, q0: int, key,
                     max_iters: int = 6) -> dict:
    """Paper Algorithm 5 (host-side reference): escalate q <- q^2 on a
    detected failure.  Returns dict(z, iters, bits, ok).

    The lattice side stays at the initial ``side(y0)`` across retries and
    only the color space grows, widening the decode margin (q-1)*s/2, as
    in the paper, where eps stays fixed and r grows."""
    kw, key = _random.split(key)
    weights = checksum_weights(kw, x_u.shape[-1], device=x_u.device)
    s0 = L.LatticeSpec(q0).side(y0)          # granularity fixed across retries
    q, bits, it = q0, 0, 0
    z, ok = None, False
    while it < max_iters:
        enc = DetectingEncoder(q=min(q, 1 << 16))
        key, ke = _random.split(key)
        y_eff = s0 * (enc.q - 1) / 2.0         # side(y_eff) == s0
        payload = enc.encode(x_u, y_eff, weights, key=ke)
        bits += enc.wire_bits(x_u.shape[-1])
        z, ok_dev = enc.decode(payload, x_v, y_eff, weights)
        it += 1
        if bool(ok_dev):
            ok = True
            break
        q = q * q                              # r <- r^2
        bits += 1                              # the failure message
    return {"z": z, "iters": it, "bits": bits, "ok": ok}
