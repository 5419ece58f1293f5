"""Bucket-space layout shared by the collectives and the agg protocol;
counterpart of ``repro.core.bucketing``.

One definition of the flat-vector <-> (n_buckets, bucket) mapping: padding
to a whole number of buckets, plus the optional per-bucket shared-randomness
Hadamard rotation (paper §6).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import rotation as R


def padded_size(n: int, bucket: int) -> int:
    """Smallest multiple of the bucket size >= n (flat wire length)."""
    b = int(bucket)
    return -(-int(n) // b) * b


def bucketize(x: torch.Tensor, bucket: int, *,
              diag: Optional[torch.Tensor] = None,
              use_kernel: bool = True) -> torch.Tensor:
    """Flat (n,) -> (n_buckets, bucket) f32, zero-padded.

    ``diag`` (a ±1 Hadamard diagonal from :func:`rotation.rotation_keypair`)
    enables the per-bucket HD rotation, inverted exactly by
    :func:`unbucketize` with the same diagonal.  ``use_kernel`` routes the
    rotation through :func:`repro_torch.kernels.ops.fwht`."""
    n = x.shape[0]
    pad = padded_size(n, bucket) - n
    v = torch.nn.functional.pad(x.to(torch.float32), (0, pad))
    v = v.reshape(-1, bucket)
    if diag is not None:
        v = R.rotate(v, diag, use_kernel=use_kernel)
    return v


def unbucketize(b: torch.Tensor, n: int, *,
                diag: Optional[torch.Tensor] = None,
                use_kernel: bool = True) -> torch.Tensor:
    """Inverse of :func:`bucketize`: (n_buckets, bucket) -> flat (n,)."""
    if diag is not None:
        b = R.unrotate(b, diag, b.shape[-1], use_kernel=use_kernel)
    return b.reshape(-1)[:int(n)]
