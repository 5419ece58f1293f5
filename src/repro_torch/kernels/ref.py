"""Plain torch versions of every kernel (the ``ref.py`` contract).

They delegate to :mod:`repro_torch.core`, the same code the rest of the
port uses, and run on any device.  The CPU tests run them against the JAX
package; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
Packed words are int32 bit views throughout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import lattice as L
from repro_torch.core import rotation as R


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Normalized Walsh-Hadamard transform over the last axis."""
    return R.fwht_torch(x)


def expand_sides(s, n: int, bucket: Optional[int] = None, device=None
                 ) -> torch.Tensor:
    """Sides as the plain math broadcasts them: a scalar stays a scalar
    tensor, per-coordinate sides stay as they are, and per-bucket sides
    (..., nb) with ``bucket`` are repeated out to (..., n)."""
    sa = torch.as_tensor(s, dtype=torch.float32, device=device)
    if bucket is None or sa.dim() == 0:
        return sa
    return torch.repeat_interleave(sa, int(bucket), dim=-1)[..., :n]


def lattice_encode_ref(x: torch.Tensor, u: torch.Tensor, s, *, q: int,
                       bits: int, return_coords: bool = False,
                       anchor: Optional[torch.Tensor] = None,
                       bucket: Optional[int] = None):
    """Packed mod-q colors of round((x - anchor)/s - u); s is scalar,
    per-coordinate, or per-bucket with ``bucket``; anchor is optional."""
    xv = x.to(torch.float32) - anchor if anchor is not None else x
    k = L.encode_coords(xv, expand_sides(s, x.shape[-1], bucket, x.device), u)
    words = L.pack_colors(L.color_of(k, q), bits)
    return (words, k) if return_coords else words


def lattice_decode_ref(words: torch.Tensor, anchor: torch.Tensor,
                       u: torch.Tensor, s, *, q: int, bits: int, n: int,
                       avg_cnt: Optional[int] = None, mode: str = "point",
                       ref: Optional[torch.Tensor] = None,
                       bucket: Optional[int] = None) -> torch.Tensor:
    """One payload vs the (n,) anchor -> int32 coords (``mode="coords"``)
    or f32 points z = (k + u) * s (+ ref).  With ``avg_cnt`` the point gets
    the running-average epilogue ``(z + anchor * avg_cnt) * recip``, with
    ``recip`` the f32 rounding of 1 / (avg_cnt + 1), as the TPU kernel
    computes it (a multiply, not a division)."""
    if mode not in ("coords", "point"):
        raise ValueError(f"mode must be 'coords' or 'point', got {mode!r}")
    if avg_cnt is not None and mode != "point":
        raise ValueError("avg_cnt needs mode='point'")
    colors = L.unpack_colors(words, n, bits)
    sa = expand_sides(s, n, bucket, anchor.device)
    av = anchor.to(torch.float32) - ref if ref is not None else anchor
    k = L.decode_coords(colors, av, sa, u, q=q)
    if mode == "coords":
        return k
    z = L.coords_to_point(k, sa, u, torch.float32)
    if ref is not None:
        z = z + ref
    if avg_cnt is not None:
        # a Python float scalar is rounded to f32 before the multiply
        z = (z + anchor.to(torch.float32) * avg_cnt) * (1.0 / (avg_cnt + 1))
    return z


def lattice_decode_batched_ref(words: torch.Tensor, anchor: torch.Tensor,
                               u: torch.Tensor, s, *, q: int, bits: int,
                               n: int, mode: str = "coords",
                               ref: Optional[torch.Tensor] = None,
                               bucket: Optional[int] = None) -> torch.Tensor:
    """(senders, n_words) payloads vs one (n,) anchor -> (senders, n)."""
    colors = L.unpack_colors(words, n, bits)            # (senders, n)
    sa = expand_sides(s, n, bucket, anchor.device)
    av = anchor.to(torch.float32) - ref if ref is not None else anchor
    k = L.decode_coords(colors, av[None], sa, u[None], q=q)
    if mode == "coords":
        return k
    z = L.coords_to_point(k, sa, u[None], torch.float32)
    if ref is not None:
        z = z + ref[None]
    return z


def lattice_residuals_ref(words: torch.Tensor, k0: torch.Tensor, *, q: int,
                          bits: int, n: int) -> torch.Tensor:
    """Centered mod-q residuals ``centered_mod(c - k0, q)`` of packed colors
    about reference coordinates k0: the integer-only half of proximity
    decode, so ``k0 + r`` is exactly the batched decode's coords output.
    words: (..., n_words); k0: (n,) int32 -> (..., n) int32."""
    colors = L.unpack_colors(words, n, bits)
    return L.centered_mod(colors - k0.to(torch.int32), q)


def lattice_pack_coords_ref(k: torch.Tensor, *, q: int,
                            bits: int) -> torch.Tensor:
    """Packed mod-q color words of int32 lattice coordinates."""
    return L.pack_colors(L.color_of(k, q), bits)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain-softmax attention.  q: (BH, Sq, D); k/v: (BH, Sk, D) ->
    (BH, Sq, D) in q's dtype, f32 inside, scores scaled by ``scale``
    (1/sqrt(D) where not given; a padded call passes the unpadded D's).
    Where causal, a score with query position < key position (both
    counted from 0) is replaced by -1e30."""
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32))
    s = s / math.sqrt(q.shape[-1]) if scale is None else s * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)
