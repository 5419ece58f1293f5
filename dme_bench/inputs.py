"""Inputs of a run, all drawn from its ``--seed``.

The vectors follow the paper's setting, vectors concentrated around a
mean of large norm: a mean ``base ~ N(0, 1)`` of the configuration's width
and, for each round and client, ``base + noise * N(0, 1)``, made on the
run's device by a ``torch.Generator`` seeded from the run seed, the round
and the client.  The same seed gives the same vectors on the same device,
so the reference makes them again rather than keeping them.
"""
from __future__ import annotations

import hashlib
import struct
import zlib

import torch


def derive(seed: int, *tags: int) -> int:
    """A 63-bit generator seed from a run seed of any size and tags."""
    raw = struct.pack("<" + "q" * (len(tags) + 1),
                      *((int(seed) % (1 << 64)) - (1 << 63), *tags))
    return int.from_bytes(hashlib.sha256(raw).digest()[:8], "little") >> 1


def spec_seed(seed: int) -> int:
    """The round contract's shared-randomness seed (31 bits: a frame
    carries it as a uint32) for a run seed of any size."""
    return zlib.crc32(struct.pack("<Q", int(seed) % (1 << 64))) & 0x7FFFFFFF


def base_vector(d: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(derive(seed, -1))
    return torch.randn(d, generator=g, device=device)


def client_vector(base: torch.Tensor, seed: int, rnd: int, client: int,
                  noise: float) -> torch.Tensor:
    """Client ``client``'s vector in round ``rnd`` (the warm-up round is
    -1)."""
    g = torch.Generator(device=base.device).manual_seed(
        derive(seed, rnd, client))
    return base + noise * torch.randn(base.shape[0], generator=g,
                                      device=base.device)


def priority(seed: int, rnd: int) -> int:
    """Round ``rnd``'s place in the run's sample: the rounds checked are
    the completed ones of the least priority, a sample drawn from the
    seed whatever the number of rounds."""
    return derive(seed, -2, rnd)
