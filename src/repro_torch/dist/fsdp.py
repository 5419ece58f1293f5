"""FSDP helpers; counterpart of ``repro.dist.fsdp``.

Only the storage-size rule is ported so far: recursive halving
(:func:`repro_torch.dist.collectives.rh_reduce_scatter_mean`) needs the
bucket count divisible by the world size.
"""
from __future__ import annotations


def pad_to_shardable(n: int, dp: int, bucket: int) -> int:
    """Smallest multiple of dp*bucket >= n (flat storage size of a leaf)."""
    g = max(dp * bucket, 1)
    return -(-max(n, 1) // g) * g
