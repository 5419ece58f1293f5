"""Error detection in quantization (paper §5); counterpart of
``repro.core.error_detect`` (the checksum half; ``DetectingEncoder`` and
``robust_agreement`` are not ported yet).

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
"""
from __future__ import annotations

import torch

from repro_torch import random as _random

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
