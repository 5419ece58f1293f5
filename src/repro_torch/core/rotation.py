"""Structured random rotation HD (paper §6, RLQSGD); counterpart of
``repro.core.rotation``.

H is the normalized Walsh-Hadamard matrix, D a random ±1 diagonal drawn
from shared randomness.  ``rotate(x) = H @ (D * x)``; the inverse is
``D * (H @ x)``.  Non-power-of-two lengths are zero-padded to the next
power of two.

``fwht_torch`` is the plain transform (the port of ``fwht_jnp``); with
``use_kernel=True`` the rotation goes through
:func:`repro_torch.kernels.ops.fwht`, which launches the CUDA kernel for a
CUDA tensor and runs ``fwht_torch`` for a CPU one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as _random


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


def fwht_torch(x: torch.Tensor) -> torch.Tensor:
    """Normalized fast Walsh-Hadamard transform over the last axis.

    Last axis length must be a power of two.  Computed in f32 with the
    same butterfly stage order as the reference's ``fwht_jnp`` and cast
    back to the input dtype."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"fwht needs power-of-two dim, got {d}")
    lead = tuple(x.shape[:-1])
    v = x.to(torch.float32)
    h = 1
    while h < d:
        v = v.reshape(lead + (d // (2 * h), 2, h))
        a = v[..., 0, :]
        b = v[..., 1, :]
        v = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    v = v.reshape(lead + (d,)) * float(np.float32(1.0 / np.sqrt(d)))
    return v.to(x.dtype)


def rademacher_diag(key, d: int, *, device=None) -> torch.Tensor:
    """Shared-randomness ±1 diagonal D (costs d bits to agree on; paper §6)."""
    return _random.rademacher(key, (d,), device=device)


def _fwht(x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.fwht(x)
    return fwht_torch(x)


def rotate(x: torch.Tensor, diag: torch.Tensor, *,
           use_kernel: bool = False) -> torch.Tensor:
    """Apply HD to the last axis (zero-padding to a power of two)."""
    d = x.shape[-1]
    dp = next_pow2(d)
    v = x.to(torch.float32) * diag[:d]
    if dp != d:
        v = torch.nn.functional.pad(v, (0, dp - d))
    return _fwht(v, use_kernel)


def unrotate(x: torch.Tensor, diag: torch.Tensor, d: int, *,
             use_kernel: bool = False) -> torch.Tensor:
    """Apply (HD)^-1 = D H; returns the first d coordinates."""
    v = _fwht(x, use_kernel)
    return v[..., :d] * diag[:d]


def rotation_keypair(key, d: int, *, device=None) -> torch.Tensor:
    """Generate the diagonal once per run (shared across machines)."""
    return rademacher_diag(key, next_pow2(d), device=device)


def rotated_coord_bound(l2, d: int, beta: float = 1e-3) -> float:
    """Paper §6 (Lemma 24): with probability >= 1 - beta over the shared
    HD rotation, ``|HD x|_inf <= ||x||_2 * sqrt(2 ln(2d/beta) / d)``."""
    return float(l2) * float(np.sqrt(2.0 * np.log(2.0 * d / beta) / d))
