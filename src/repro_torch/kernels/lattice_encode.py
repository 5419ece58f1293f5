"""Wrapper of the fused lattice-encode CUDA kernel
(``csrc/lattice_encode.cuh``: ``lattice_encode.cu`` for q a power of two,
``lattice_encode_any.cu`` for q not one).

Counterpart of ``repro.kernels.lattice_encode.lattice_encode_pallas``: one
pass over x computes ``k = round((x - anchor)/s - u)``, the mod-q colors
and their bit-packed words (plus the int32 coordinates when asked), for
any q in [1, 65536] and any n >= 1.  The plain torch version is
:func:`repro_torch.kernels.ref.lattice_encode_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import lattice as L
from repro_torch.kernels import _build

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the launch is a persistent grid striding over runs of 4 words with int64
# indices, so the grid does not bound n; 2^60 keeps every byte offset of
# the 4-byte streams (4 n) inside int64
MAX_N = 1 << 60


def lattice_encode_fake(x: torch.Tensor, u: torch.Tensor, s,
                        anchor: Optional[torch.Tensor] = None, *, q: int,
                        return_coords: bool = False):
    """The encode's shape-only implementation for a ``meta`` tensor:
    outputs of the kernel's shapes and dtypes, one call recorded."""
    n = x.numel()
    words = torch.empty(L.packed_len(n, _build.lattice_bits(q)),
                        dtype=torch.int32, device=x.device)
    coords = (torch.empty(n, dtype=torch.int32, device=x.device)
              if return_coords else None)
    _build.record_fake("lattice_encode", (x, u, s, anchor), (words, coords))
    return (words, coords) if return_coords else words


@functools.cache
def _launcher(q_pow2: bool = True):
    """The C launcher for q a power of two (or, with ``q_pow2`` false, not
    one), loaded and typed once each."""
    lib = _build.lattice_library("lattice_encode", q_pow2)
    fn = getattr(_build.load(lib), f"{lib}_launch")
    fn.argtypes = [_P, _P, _P, _P, _I, _P, _P, _I64, _I, _I, _P]
    fn.restype = _I
    return fn


def lattice_encode_cuda(x: torch.Tensor, u: torch.Tensor, s,
                        anchor: Optional[torch.Tensor] = None, *, q: int,
                        return_coords: bool = False,
                        bucket: Optional[int] = None):
    """Encode flat f32 x (n,) on the card.

    ``s`` is a scalar, a per-coordinate (n,) array, or per-bucket sides
    (nb,) with ``bucket``.  Returns the packed words (int32 bit view,
    ``packed_len(n, bits)`` of them), plus the int32 coordinates (n,) when
    ``return_coords``."""
    bits = _build.lattice_bits(q)
    dev = x.device
    n = x.numel()
    _build.check_lattice_shape("encode", q, bits, n)
    if n > MAX_N:
        raise ValueError(f"the encode kernel takes at most {MAX_N} "
                         f"coordinates in one launch, got {n}")
    _build.check_tensor(x, "x", torch.float32, dev, (n,))
    _build.check_tensor(u, "u", torch.float32, dev, (n,))
    if anchor is not None:
        _build.check_tensor(anchor, "anchor", torch.float32, dev, (n,))
    sides, _, shift = _build.side_layout(s, n, dev, bucket=bucket)
    words = torch.empty(L.packed_len(n, bits), dtype=torch.int32, device=dev)
    coords = (torch.empty(n, dtype=torch.int32, device=dev)
              if return_coords else None)
    stream = _build.current_stream(dev)
    err = _launcher(_build.pow2(q))(
        x.data_ptr(), anchor.data_ptr() if anchor is not None else None,
        u.data_ptr(), sides.data_ptr(), shift, words.data_ptr(),
        coords.data_ptr() if coords is not None else None, n, q, bits,
        stream)
    _build.check(err, "lattice_encode")
    _build.LAUNCHES["lattice_encode"] += 1
    return (words, coords) if return_coords else words
