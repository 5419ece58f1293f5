"""Wrappers of the lattice-decode CUDA kernels (``csrc/lattice_decode.cuh``:
``lattice_decode.cu`` for q a power of two, ``lattice_decode_any.cu`` for q
not one; any q in [1, 65536] and any n >= 1).

* :func:`lattice_decode_cuda`, counterpart of
  ``repro.kernels.lattice_decode.lattice_decode_pallas``: one payload
  against the anchor, to int32 coordinates (``mode="coords"``) or f32
  points (``mode="point"``, with the optional running-average epilogue).
  The butterfly and recursive-halving collectives launch it once per rank
  per round.  Plain version:
  :func:`repro_torch.kernels.ref.lattice_decode_ref`.
* :func:`lattice_decode_batched_cuda`, counterpart of
  ``lattice_decode_batched_pallas``: one launch decodes every sender's
  payload against the shared anchor (the star collective and the server's
  drain).  Plain version:
  :func:`repro_torch.kernels.ref.lattice_decode_batched_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import lattice as L
from repro_torch.kernels import _build

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float


def _check_words(words: torch.Tensor, n: int, bits: int) -> None:
    if words.dim() < 1 or words.shape[-1] < L.packed_len(n, bits):
        raise ValueError(f"words of shape {tuple(words.shape)} cannot hold "
                         f"{n} coordinates at {bits} bits")


def lattice_decode_fake(words: torch.Tensor, anchor: torch.Tensor,
                        u: torch.Tensor, s, *, mode: str,
                        ref: Optional[torch.Tensor] = None,
                        batched: bool = False) -> torch.Tensor:
    """The single (or, with ``batched``, the batched) decode's shape-only
    implementation for a ``meta`` tensor: (n,) or (senders, n) int32
    coords or f32 points, one call recorded."""
    n = anchor.numel()
    shape = (words.shape[0], n) if batched else (n,)
    out = torch.empty(shape, device=anchor.device,
                      dtype=torch.int32 if mode == "coords"
                      else torch.float32)
    _build.record_fake("lattice_decode_batched" if batched
                       else "lattice_decode", (words, anchor, u, s, ref),
                       (out,))
    return out


def _typed(name: str, q_pow2: bool, argtypes: list):
    """The C launcher ``lattice_<name>[_any]_launch`` of the decode library
    for q a power of two (``q_pow2``) or not, typed."""
    lib = _build.lattice_library("lattice_decode", q_pow2)
    fn = getattr(_build.load(lib),
                 f"lattice_{name}{lib[len('lattice_decode'):]}_launch")
    fn.argtypes, fn.restype = argtypes, _I
    return fn


@functools.cache
def _single_launcher(q_pow2: bool = True):
    """The single decode's C launcher for q a power of two (or, with
    ``q_pow2`` false, not one), loaded and typed once each."""
    return _typed("decode", q_pow2, [_P, _P, _P, _P, _P, _I, _P, _I, _I, _F,
                                     _F, _I64, _I, _I, _P])


def lattice_decode_cuda(words: torch.Tensor, anchor: torch.Tensor,
                        u: torch.Tensor, s, *, q: int,
                        avg_cnt: Optional[int] = None, mode: str = "point",
                        ref: Optional[torch.Tensor] = None,
                        bucket: Optional[int] = None) -> torch.Tensor:
    """Decode one payload's packed words (int32 bit view) against the f32
    anchor (n,) on the card -> (n,) int32 coords or f32 points.

    ``s`` is a scalar, a per-coordinate (n,) array, or per-bucket sides
    (nb,) with ``bucket``; ``ref`` (n,) is the anchor the sender
    subtracted.  ``avg_cnt`` (point mode only) adds the epilogue
    ``(z + anchor * avg_cnt) * f32(1 / (avg_cnt + 1))``."""
    if mode not in ("coords", "point"):
        raise ValueError(f"mode must be 'coords' or 'point', got {mode!r}")
    if avg_cnt is not None and mode != "point":
        raise ValueError("avg_cnt needs mode='point'")
    bits = _build.lattice_bits(q)
    dev = anchor.device
    n = anchor.numel()
    _build.check_lattice_shape("decode", q, bits, n)
    _check_words(words, n, bits)
    if words.dim() != 1:
        raise ValueError(f"words must be one payload (1-d), got shape "
                         f"{tuple(words.shape)}")
    _build.check_tensor(words, "words", torch.int32, dev)
    _build.check_tensor(anchor, "anchor", torch.float32, dev, (n,))
    _build.check_tensor(u, "u", torch.float32, dev, (n,))
    if ref is not None:
        _build.check_tensor(ref, "ref", torch.float32, dev, (n,))
    sides, _, shift = _build.side_layout(s, n, dev, bucket=bucket)
    coords = mode == "coords"
    avg = avg_cnt is not None
    # the TPU kernel's scalars: avg_cnt as f32, and 1 / (avg_cnt + 1)
    # computed in double and rounded to f32 (ctypes rounds both)
    cnt = float(avg_cnt) if avg else 0.0
    recip = 1.0 / (avg_cnt + 1) if avg else 1.0
    out = torch.empty(n, device=dev,
                      dtype=torch.int32 if coords else torch.float32)
    stream = _build.current_stream(dev)
    err = _single_launcher(_build.pow2(q))(
        words.data_ptr(), anchor.data_ptr(), u.data_ptr(),
        ref.data_ptr() if ref is not None else None, sides.data_ptr(), shift,
        out.data_ptr(), int(coords), int(avg), cnt, recip, n, q, bits,
        stream)
    _build.check(err, "lattice_decode")
    _build.LAUNCHES["lattice_decode"] += 1
    return out


@functools.cache
def _launcher(q_pow2: bool = True):
    """The batched decode's C launcher for q a power of two (or, with
    ``q_pow2`` false, not one), loaded and typed once each."""
    return _typed("decode_batched", q_pow2, [_P, _I64, _P, _P, _P, _P, _I64,
                                             _I, _P, _I, _I64, _I64, _I, _I,
                                             _P])


def lattice_decode_batched_cuda(words: torch.Tensor, anchor: torch.Tensor,
                                u: torch.Tensor, s, *, q: int,
                                mode: str = "coords",
                                ref: Optional[torch.Tensor] = None,
                                bucket: Optional[int] = None
                                ) -> torch.Tensor:
    """Decode (senders, n_words) packed words (int32 bit view) against the
    f32 anchor (n,) on the card -> (senders, n) int32 coords or f32 points.

    ``s`` is a scalar, shared (n,), per-sender (senders, n), or per-sender
    per-bucket (senders, nb) with ``bucket`` (or shared per-bucket (nb,));
    ``ref`` (n,) is the anchor every sender subtracted before encoding."""
    if mode not in ("coords", "point"):
        raise ValueError(f"mode must be 'coords' or 'point', got {mode!r}")
    bits = _build.lattice_bits(q)
    dev = anchor.device
    n = anchor.numel()
    _build.check_lattice_shape("decode", q, bits, n)
    _check_words(words, n, bits)
    if words.dim() != 2:
        raise ValueError(f"words must be (senders, n_words), got shape "
                         f"{tuple(words.shape)}")
    senders = words.shape[0]
    _build.check_tensor(words, "words", torch.int32, dev)
    _build.check_tensor(anchor, "anchor", torch.float32, dev, (n,))
    _build.check_tensor(u, "u", torch.float32, dev, (n,))
    if ref is not None:
        _build.check_tensor(ref, "ref", torch.float32, dev, (n,))
    sides, s_row, shift = _build.side_layout(s, n, dev, bucket=bucket,
                                             senders=senders)
    coords = mode == "coords"
    out = torch.empty((senders, n), device=dev,
                      dtype=torch.int32 if coords else torch.float32)
    stream = _build.current_stream(dev)
    err = _launcher(_build.pow2(q))(
        words.data_ptr(), words.shape[1], anchor.data_ptr(), u.data_ptr(),
        ref.data_ptr() if ref is not None else None, sides.data_ptr(), s_row,
        shift, out.data_ptr(), int(coords), senders, n, q, bits, stream)
    _build.check(err, "lattice_decode_batched")
    _build.LAUNCHES["lattice_decode_batched"] += 1
    return out
