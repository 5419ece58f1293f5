"""Quantized-sync configuration shared with the agg protocol; the part of
``repro.dist.collectives`` that the aggregation round's frame needs.

The star, butterfly and recursive-halving collectives themselves are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core import bucketing as B
from repro_torch.core import lattice as L

# Fixed seed for the shared-randomness Hadamard diagonal: every party
# derives the same D without communication (one agreed constant stands in
# for the d shared bits of §6).
_ROTATION_SEED = 20210507


@dataclasses.dataclass(frozen=True)
class QSyncConfig:
    """Static config of the quantized sync path.

    q:      number of mod-q color classes; wire cost bits_for_q(q) bits/coord
            and lattice side s = 2*y/(q-1) for distance bound y.
    bucket: coordinates per bucket (power of two); each bucket has its own
            y / s and (optionally) its own Hadamard rotation block.
    rotate: pre-rotate buckets with the shared-randomness HD transform
            (paper §6) so adversarially-concentrated coordinates spread out.
    packed: carry packed uint32 words plus the per-bucket sides sidecar on
            the wire, through the fused kernels.
    """
    q: int = 16
    bucket: int = 4096
    rotate: bool = False
    packed: bool = True

    def __post_init__(self):
        if self.q < 2:
            raise ValueError("q must be >= 2")
        b = self.bucket
        if b < 1 or (b & (b - 1)) != 0:
            raise ValueError(f"bucket must be a power of two, got {b}")

    @property
    def bits(self) -> int:
        return L.bits_for_q(self.q)

    @property
    def spec(self) -> L.LatticeSpec:
        return L.LatticeSpec(self.q)


def flat_size_padded(n: int, cfg: Union[QSyncConfig, int]) -> int:
    """Smallest multiple of the bucket size >= n (flat wire length)."""
    b = cfg.bucket if isinstance(cfg, QSyncConfig) else int(cfg)
    return B.padded_size(n, b)
