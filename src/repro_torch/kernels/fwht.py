"""Wrapper of the Walsh-Hadamard CUDA kernel (``csrc/fwht.cu``).

Counterpart of ``repro.kernels.fwht.fwht_pallas``: the normalized FWHT
over the last axis, f32 or bf16 (f32 inside), equal to the plain torch
version :func:`repro_torch.kernels.ref.fwht_ref` bit for bit.  A tensor
whose data does not start on a 16-byte boundary takes the same kernel with
one-element loads and stores (the C launcher picks them from the
pointers); nothing is copied.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

# the reference kernel's range of row lengths (powers of two)
MIN_D, MAX_D = 4, 16384
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = _build.load("fwht").fwht_launch
    fn.argtypes = [_P, _P, _I64, _I, _F, _I, _P]
    fn.restype = _I
    return fn


def fwht_fake(x: torch.Tensor) -> torch.Tensor:
    """The FWHT's shape-only implementation for a ``meta`` tensor: rows as
    given, one call recorded."""
    out = torch.empty_like(x)
    _build.record_fake("fwht", (x,), (out,))
    return out


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """Normalized FWHT of x (..., d) on the card; d a power of two in
    [MIN_D, MAX_D]."""
    d = x.shape[-1]
    if d < MIN_D or d & (d - 1) or d > MAX_D:
        raise ValueError(f"the fwht kernel needs d a power of two in "
                         f"[{MIN_D}, {MAX_D}], got {d}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the fwht kernel takes f32 or bf16, got {x.dtype}")
    _build.check_tensor(x, "x", x.dtype, x.device)
    out = torch.empty_like(x)
    rows = x.numel() // d
    scale = float(np.float32(1.0 / np.sqrt(d)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher()(x.data_ptr(), out.data_ptr(), rows, d.bit_length() - 1,
                      scale, _DTYPES[x.dtype], stream)
    _build.check(err, "fwht")
    _build.LAUNCHES["fwht"] += 1
    return out
