"""Plain reference of one client's round: the frame a client must send.

From the client's vector ``x`` and the round contract it works out again
everything the frame carries: the per-bucket Hadamard rotation (paper §6,
when the contract rotates), the shared dither ``u ~ U[-1/2, 1/2)`` of the
round, the lattice coordinates ``k = round(x_b / s - u)`` (half to even),
their mod-q colors packed into little-endian uint32 words, the §5 checksum
``sum(k * a) mod 2^32`` under the round's odd weights ``a``, and the
framing.  Plain torch on the caller's device, in blocks of buckets so that
the full-width vector fits beside the program's leftovers; it imports
nothing of the program.

``dtype`` is the precision of the float steps (the rotation, the division
and the dither's subtraction): float32 is the contract's; bfloat16 makes
the control that the comparison must fail.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dme_bench.reference import frame as F
from dme_bench.reference import threefry as T
from dme_bench.roofline import bits_for_q

# coordinates a block: its int64 temporaries stay near a GB
BLOCK = 1 << 24


@dataclasses.dataclass(frozen=True)
class Contract:
    """A round's contract as far as one client's frame needs it."""
    d: int
    q: int
    bucket: int
    y0: float
    rotate: bool
    rot_seed: int

    @property
    def padded(self) -> int:
        return -(-self.d // self.bucket) * self.bucket

    @property
    def nb(self) -> int:
        return self.padded // self.bucket

    @property
    def bits(self) -> int:
        return bits_for_q(self.q)

    @property
    def side(self) -> np.float32:
        """The f32 lattice side of every bucket: 2 y0 / (q - 1), as the
        f32 product of y0 and the f32 rounding of 2 / (q - 1)."""
        return np.float32(np.float32(self.y0) * np.float32(2.0 / (self.q - 1)))


def round_key(seed: int, round_id: int):
    return T.fold_in(T.prng_key(seed), round_id)


def fwht_rows(v: torch.Tensor) -> torch.Tensor:
    """Normalized Walsh-Hadamard transform of each row, butterfly by
    butterfly (stage h pairs elements h apart: a + b, a - b), then scaled
    by the rounding of 1 / sqrt(row) to the input's precision."""
    rows, d = v.shape
    h = 1
    while h < d:
        w = v.reshape(rows, d // (2 * h), 2, h)
        v = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 0] - w[:, :, 1]],
                        dim=2)
        h *= 2
    return v.reshape(rows, d) * float(np.float32(1.0 / math.sqrt(d)))


def encode(x: torch.Tensor, c: Contract, seed: int, round_id: int,
           dtype=torch.float32) -> "tuple[torch.Tensor, int]":
    """(packed words as an int32 bit view on x's device, checksum)."""
    dev = x.device
    key = round_key(seed, round_id)
    wkey = T.fold_in(key, 1)
    diag = (T.rademacher(T.prng_key(c.rot_seed), c.bucket, dev).to(dtype)
            if c.rotate else None)
    side = torch.tensor(float(c.side), dtype=torch.float32,
                        device=dev).to(dtype)
    per = 32 // c.bits
    shifts = torch.arange(per, dtype=torch.int64, device=dev) * c.bits
    words = torch.empty(c.padded // per, dtype=torch.int32, device=dev)
    check = 0
    for c0 in range(0, c.padded, BLOCK):
        c1 = min(c.padded, c0 + BLOCK)
        v = torch.zeros(c1 - c0, dtype=dtype, device=dev)
        if c0 < c.d:
            v[:min(c1, c.d) - c0] = x[c0:min(c1, c.d)].to(dtype)
        v = v.reshape(-1, c.bucket)
        if diag is not None:
            v = fwht_rows(v * diag)
        u = T.uniform(key, (c0, c1), -0.5, 0.5, dev).to(dtype)
        k = torch.round(v.reshape(-1) / side - u).to(torch.int32)
        del v, u
        colors = torch.remainder(k, c.q).to(torch.int64).reshape(-1, per)
        words[c0 // per:c1 // per] = T.int32_view(
            torch.sum(colors << shifts, dim=1))
        del colors
        w = T.bits(wkey, (c0, c1), dev).to(torch.int64) | 1
        check += int(((k.to(torch.int64) * (w & T.M32)) & T.M32).sum())
        del k, w
    return words, check & T.M32


def frame(x: torch.Tensor, c: Contract, seed: int, round_id: int,
          client_id: int, dtype=torch.float32) -> bytes:
    """The client's one frame of the round (attempt 0, unchunked)."""
    words, check = encode(x, c, seed, round_id, dtype)
    return framed(c, seed, round_id, client_id, words.cpu().numpy(), check)


def framed(c: Contract, seed: int, round_id: int, client_id: int,
           words: np.ndarray, check: int) -> bytes:
    """The frame around host words and their checksum."""
    return F.client_frame(
        round_id=round_id, client_id=client_id, q=c.q, d=c.d,
        bucket=c.bucket, seed=seed, rot_seed=c.rot_seed, rotate=c.rotate,
        check=check, words=words.tobytes(),
        sides=np.full(c.nb, c.side, np.float32).tobytes())


def bad_bytes(got: "list[bytes]", want: bytes) -> int:
    """Bytes of the sent frames (joined) that differ from the reference
    frame, a missing or surplus byte counting as one."""
    g = b"".join(got)
    n = min(len(g), len(want))
    a = np.frombuffer(g, np.uint8, count=n)
    b = np.frombuffer(want, np.uint8, count=n)
    return int(np.count_nonzero(a != b)) + abs(len(g) - len(want))


class ReferenceClient:
    """The reference in a client's place: ``encode()`` then ``frames()``,
    as the program's client is driven.  In bfloat16 it is the control."""

    def __init__(self, c: Contract, seed: int, round_id: int,
                 client_id: int, x: torch.Tensor, dtype=torch.bfloat16):
        self.c, self.seed, self.round_id = c, seed, round_id
        self.client_id, self.x, self.dtype = client_id, x, dtype
        self._words = self._frames = None

    def encode(self):
        if self._words is None:
            words, check = encode(self.x, self.c, self.seed, self.round_id,
                                  self.dtype)
            self._words = (words.cpu().numpy().view(np.uint32), check)
        return self._words

    def frames(self) -> "list[bytes]":
        if self._frames is None:
            words, check = self.encode()
            self._frames = [framed(self.c, self.seed, self.round_id,
                                   self.client_id, words, check)]
        return list(self._frames)
