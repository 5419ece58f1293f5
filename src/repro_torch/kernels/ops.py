"""Public kernel entry points; counterpart of ``repro.kernels.ops``.

The device of the input picks the path, and nothing else does: a CPU
tensor runs the plain torch version in :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the hand-written kernel, or the call raises.  There is
no fallback from the card to the plain version.  A ``meta`` tensor (the
dry run's traced step, ``launch/dryrun.py``) holds no data: it goes to
the kernel's shape-only implementation, which returns outputs of the
kernel's shapes and records the call, so that a trace counts the kernel
as one op and not the plain version's ops.  No real tensor takes that
branch.

Shape rules: every shape the reference's ops computes goes to a kernel.
The lattice kernels take any q in [1, 65536] (1 to 16 bits per color, q a
power of two or not) and any n >= 1; the FWHT takes rows of any power of
two, f32 or bf16 (rows past 16,384 in several launches); attention takes
any BH, Sq, Sk and D >= 1, in f32, bf16 or f16.  The reference's kernels
take less (q a power of two with 2 to 16 bits, n >= 32, FWHT rows in
[4, 16384], attention with Sq >= 16 and Sq, Sk multiples of min(256, S))
and send the rest to their plain versions, which compute the same
functions.  A CUDA tensor raises only where the reference raises: q
outside [1, 65536], n < 1, an FWHT row that is not a power of two, and a
dtype no kernel takes.

``DISPATCH_COUNTS`` keeps the reference's semantics: one count per
decode call (single or batched), whichever device ran it, so a drain can
be shown to issue exactly one batched decode; a ``meta`` tensor's call
is counted apart, in ``_build.FAKE_LAUNCHES``.  The residual and packing
helpers are plain torch integer ops on either device (jitted jnp in the
reference, not Pallas) and are deliberately not counted.  The per-kernel
launch counts live in :data:`repro_torch.kernels._build.LAUNCHES`.
"""
from __future__ import annotations

from typing import Optional

import torch

import repro_torch.obs as _obs
from repro_torch.core import lattice as L
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_fake)
from repro_torch.kernels.fwht import fwht_cuda, fwht_fake
from repro_torch.kernels.lattice_decode import (lattice_decode_batched_cuda,
                                                lattice_decode_cuda,
                                                lattice_decode_fake)
from repro_torch.kernels.lattice_encode import (lattice_encode_cuda,
                                                lattice_encode_fake)

_DISPATCH = {
    "lattice_decode": _obs.registry().counter("kernel_dispatch",
                                              kernel="lattice_decode"),
    "lattice_decode_batched": _obs.registry().counter(
        "kernel_dispatch", kernel="lattice_decode_batched"),
}


class _DispatchCounts:
    """Dict-shaped live view over the registry dispatch counters."""
    __slots__ = ()

    def __getitem__(self, k: str) -> int:
        return _DISPATCH[k].value

    def get(self, k: str, default=None):
        c = _DISPATCH.get(k)
        return default if c is None else c.value

    def __contains__(self, k) -> bool:
        return k in _DISPATCH

    def __iter__(self):
        return iter(_DISPATCH)

    def __len__(self) -> int:
        return len(_DISPATCH)

    def keys(self):
        return _DISPATCH.keys()

    def values(self):
        return [c.value for c in _DISPATCH.values()]

    def items(self):
        return [(k, c.value) for k, c in _DISPATCH.items()]

    def __eq__(self, other):
        return dict(self.items()) == other

    def __repr__(self) -> str:
        return repr(dict(self.items()))


DISPATCH_COUNTS = _DispatchCounts()


def reset_dispatch_counts() -> None:
    for c in _DISPATCH.values():
        c.reset()


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Normalized Walsh-Hadamard over the last axis."""
    if x.is_meta:
        return fwht_fake(x)
    if _on_cpu(x):
        return _ref.fwht_ref(x)
    return fwht_cuda(x.contiguous())


def lattice_encode(x: torch.Tensor, u: torch.Tensor, s, *, q: int,
                   return_coords: bool = False,
                   anchor: Optional[torch.Tensor] = None,
                   bucket: Optional[int] = None):
    """Fused encode of flat x -> packed words (int32 bit view), plus the
    int32 coordinates when asked.

    s is a scalar side, a per-coordinate (N,) array, or per-bucket sides
    (nb,) with ``bucket`` (never broadcast to (N,) on the card).
    ``anchor`` (N,), when given, is subtracted in the kernel:
    k = round((x - anchor)/s - u)."""
    if x.is_meta:
        return lattice_encode_fake(x, u, s, anchor, q=q,
                                   return_coords=return_coords)
    if _on_cpu(x):
        return _ref.lattice_encode_ref(x, u, s, q=q, bits=L.bits_for_q(q),
                                       return_coords=return_coords,
                                       anchor=anchor, bucket=bucket)
    return lattice_encode_cuda(x, u, s, anchor, q=q,
                               return_coords=return_coords, bucket=bucket)


def lattice_decode(words: torch.Tensor, anchor: torch.Tensor,
                   u: torch.Tensor, s, *, q: int,
                   avg_cnt: Optional[int] = None, mode: str = "point",
                   ref: Optional[torch.Tensor] = None,
                   bucket: Optional[int] = None) -> torch.Tensor:
    """Fused decode of one payload against the anchor (n,):
    ``mode="point"`` gives z (with the running-average epilogue when
    ``avg_cnt`` is given), ``mode="coords"`` the int32 coordinates.

    ``s`` is a scalar side, a per-coordinate (n,) array, or per-bucket
    sides (nb,) with ``bucket``; ``ref`` (n,) the anchor the sender
    subtracted."""
    if anchor.is_meta:
        return lattice_decode_fake(words, anchor, u, s, mode=mode, ref=ref)
    _DISPATCH["lattice_decode"].inc()
    if _on_cpu(anchor):
        return _ref.lattice_decode_ref(
            words, anchor, u, s, q=q, bits=L.bits_for_q(q),
            n=anchor.shape[0], avg_cnt=avg_cnt, mode=mode, ref=ref,
            bucket=bucket)
    return lattice_decode_cuda(words, anchor, u, s, q=q, avg_cnt=avg_cnt,
                               mode=mode, ref=ref, bucket=bucket)


def lattice_decode_batched(words: torch.Tensor, anchor: torch.Tensor,
                           u: torch.Tensor, s, *, q: int,
                           mode: str = "coords",
                           ref: Optional[torch.Tensor] = None,
                           bucket: Optional[int] = None) -> torch.Tensor:
    """One launch decoding (senders, n_words) payloads of the same vector
    against a shared anchor (n,) -> (senders, n).

    ``s`` is a scalar side, a shared (n,) array, a per-sender (senders, n)
    array, or per-sender per-bucket sides (senders, nb) with ``bucket``;
    ``ref`` (n,) the shared anchor all senders subtracted."""
    if anchor.is_meta:
        return lattice_decode_fake(words, anchor, u, s, mode=mode, ref=ref,
                                   batched=True)
    _DISPATCH["lattice_decode_batched"].inc()
    if _on_cpu(anchor):
        return _ref.lattice_decode_batched_ref(
            words, anchor, u, s, q=q, bits=L.bits_for_q(q),
            n=anchor.shape[0], mode=mode, ref=ref, bucket=bucket)
    return lattice_decode_batched_cuda(words, anchor, u, s, q=q, mode=mode,
                                       ref=ref, bucket=bucket)


def lattice_residuals(words: torch.Tensor, k0: torch.Tensor, *,
                      q: int) -> torch.Tensor:
    """Centered mod-q residuals of packed payloads about reference coords:
    ``k0 + r`` is exactly the batched decode's coords output, with no
    float math and no decode dispatch.  words: (..., n_words) int32 bit
    view; k0: (n,) int32 -> (..., n) int32.  Not counted."""
    return _ref.lattice_residuals_ref(words, k0, q=q, bits=L.bits_for_q(q),
                                      n=k0.shape[0])


def lattice_residuals_range(words: torch.Tensor, k0: torch.Tensor, *,
                            q: int, word_start: int = 0) -> torch.Tensor:
    """Residuals of a word-aligned slice ``[word_start, word_start +
    words.shape[-1])`` of a packed payload against the FULL (n,) k0: the
    streaming drain's range-fold primitive.  Concatenating the ranges of a
    whole payload reproduces :func:`lattice_residuals` bit for bit.  Not
    counted."""
    per = 32 // L.bits_for_q(q)
    c0 = word_start * per
    if c0 >= k0.shape[0]:
        raise ValueError(f"word_start {word_start} starts at coordinate "
                         f"{c0}, past the {k0.shape[0]}-coordinate vector")
    m = min(words.shape[-1] * per, k0.shape[0] - c0)
    return _ref.lattice_residuals_ref(words, k0[c0:c0 + m], q=q,
                                      bits=L.bits_for_q(q), n=m)


def lattice_pack_coords(k: torch.Tensor, *, q: int) -> torch.Tensor:
    """Pack int32 lattice coordinates as mod-q color words (int32 bit
    view): k (..., n) -> (..., n_words)."""
    return _ref.lattice_pack_coords_ref(k, q=q, bits=L.bits_for_q(q))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention forward over (BH, S, D) tensors, scale 1/sqrt(D).

    The reference takes blocks ``bq = min(256, Sq)``, ``bk = min(256, Sk)``
    and sends a shape its kernel does not take (Sq or Sk not a multiple
    of its block, Sq < 16) to its plain version, which computes the same
    function.  Here a CUDA tensor of any BH, Sq, Sk >= 1, any D >= 1 and
    f32, bf16 or f16 goes to a kernel, which masks a ragged edge; a D that
    no kernel is built for is padded to the next width built for its type
    (bf16 and f16 16, 32, 64, 128, 192, 256, 384, 512; f32 the same from
    64; then multiples of 512), one launch either way."""
    if q.is_meta:
        return flash_attention_fake(q, k, v)
    if _on_cpu(q):
        return _ref.flash_attention_ref(q, k, v, causal=causal)
    sq, sk = q.shape[1], k.shape[1]
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=causal, bq=min(256, sq),
                                bk=min(256, sk))
