"""Shared per-round randomness + bucket-space helpers (client & server);
counterpart of ``repro.agg.rounds``.

Everything a round's participants must agree on is derived from the
:class:`repro_torch.agg.transport.frame.RoundSpec`: the dither ``u``, the
§5 checksum weights, the §6 Hadamard diagonal (``rot_seed``), the
per-bucket sides and, in anchored rounds, the anchor itself (pinned by its
CRC-32 digest).  The draws come from :mod:`repro_torch.random`, bit-exact
with the reference's ``jax.random``, so port and reference parties of one
round agree bit for bit.  Every tensor is made on the device the caller
names: the CUDA device unless it names another; with no card and no
device named the helpers raise.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np
import torch

import repro_torch.obs as _obs
from repro_torch import random as _random
from repro_torch import resolve_device
from repro_torch.agg.transport import frame as W
from repro_torch.core import bucketing as B
from repro_torch.core import error_detect as ED
from repro_torch.core import lattice as L
from repro_torch.core import rotation as R


def fold_seed(seed: int, round_id: int) -> int:
    """Round k's wire seed: ``fold(service seed, round_id)``, masked to 31
    bits exactly as the reference masks it."""
    return zlib.crc32(struct.pack("<II", seed & 0xFFFFFFFF,
                                  round_id & 0xFFFFFFFF)) & 0x7FFFFFFF


def round_key(spec: W.RoundSpec):
    """The round's shared-randomness key (dither + checksum weights)."""
    return _random.fold_in(_random.PRNGKey(spec.seed), spec.round_id)


def dither(spec: W.RoundSpec, device=None) -> torch.Tensor:
    """Shared lattice offset u ~ U[-1/2, 1/2), shaped (nb, bucket)."""
    with _obs.span("draw.dither", round=spec.round_id):
        return L.shared_offset(round_key(spec), (spec.nb, spec.cfg.bucket),
                               device=device)


def checksum_weights(spec: W.RoundSpec, device=None) -> torch.Tensor:
    """Shared odd uint32 weights of the §5 checksum (int32 bit view),
    (padded,)."""
    with _obs.span("draw.weights", round=spec.round_id):
        return ED.checksum_weights(_random.fold_in(round_key(spec), 1),
                                   spec.padded, device=device)


def rotation_diag(spec: W.RoundSpec, device=None) -> torch.Tensor:
    """Shared ±1 Hadamard diagonal for the per-bucket HD rotation."""
    with _obs.span("draw.rotation", round=spec.round_id):
        return R.rotation_keypair(_random.PRNGKey(spec.rot_seed),
                                  spec.cfg.bucket, device=device)


def as_f32(v, device) -> torch.Tensor:
    """A numpy array or tensor as an f32 tensor on ``device`` (a CPU
    numpy array of f32 is shared, not copied, as ``np.asarray`` shares)."""
    return torch.as_tensor(v).to(device=device, dtype=torch.float32)


def bucketize(x: torch.Tensor, spec: W.RoundSpec) -> torch.Tensor:
    """Flat (d,) -> (nb, bucket) f32, zero-padded, HD-rotated if configured
    (the rotation through the FWHT kernel when the round is packed)."""
    diag = rotation_diag(spec, x.device) if spec.cfg.rotate else None
    return B.bucketize(x, spec.cfg.bucket, diag=diag,
                       use_kernel=spec.cfg.packed)


def unbucketize(b: torch.Tensor, spec: W.RoundSpec) -> torch.Tensor:
    """Inverse of :func:`bucketize`: (nb, bucket) -> flat (d,)."""
    diag = rotation_diag(spec, b.device) if spec.cfg.rotate else None
    return B.unbucketize(b, spec.d, diag=diag, use_kernel=spec.cfg.packed)


def sides(spec: W.RoundSpec, device=None) -> torch.Tensor:
    """(nb,) f32 sides sidecar — the round's fixed per-bucket granularity.
    Eager torch divides by it with a true IEEE division, so the pinning the
    reference needs against a compiler's reciprocal rewrite has no
    counterpart here."""
    return torch.from_numpy(spec.sides_np()).to(resolve_device(device))


def decode_ref_coords(spec: W.RoundSpec, anchor: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """(padded,) int32 reference coordinates ``k0 = round(ref/s - u)`` of
    the round's decode — the same float ops in the same order as the
    batched decode, so the result is bit-identical to the ``k_a`` it
    derives internally.  Anchored rounds decode against zero; unanchored
    rounds against the bucketized server anchor.  The per-bucket sides
    broadcast over each bucket instead of being repeated out to (padded,).
    """
    device = resolve_device(device)
    if spec.anchored or anchor is None:
        ref_b = torch.zeros((spec.nb, spec.cfg.bucket), dtype=torch.float32,
                            device=device)
    else:
        ref_b = bucketize(anchor.to(device=device, dtype=torch.float32), spec)
    t = ref_b / sides(spec, ref_b.device)[:, None]
    t = t - dither(spec, ref_b.device)
    return torch.round(t).to(torch.int32).reshape(-1)


def anchor_digest(anchor) -> int:
    """CRC-32 of the anchor's little-endian f32 bytes (nonzero: 0 is the
    wire's 'unanchored' sentinel)."""
    if isinstance(anchor, torch.Tensor):
        anchor = anchor.detach().cpu().numpy()
    raw = np.ascontiguousarray(np.asarray(anchor, np.float32))
    return (zlib.crc32(raw.tobytes()) & 0xFFFFFFFF) or 1


def check_anchor(spec: W.RoundSpec, anchor) -> None:
    """Validate a party's anchor vector against the round contract."""
    if not spec.anchored:
        return
    if anchor is None:
        raise ValueError(f"round {spec.round_id} is anchored "
                         f"(digest {spec.anchor_digest:#x}) but no anchor "
                         f"vector was provided")
    got = anchor_digest(anchor)
    if got != spec.anchor_digest:
        raise ValueError(f"anchor digest {got:#x} != round's "
                         f"{spec.anchor_digest:#x} (stale anchor?)")
