"""Wrapper of the flash-attention CUDA kernels.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``:
forward online-softmax attention over (BH, S, D) tensors, causal or not,
scale 1/sqrt(D), f32 or bf16 in, the input type out, f32 inside.  bf16
goes to ``csrc/flash_attention_wgmma.cu`` (wgmma on the tensor cores, K/V
by TMA, P split into two bf16 terms), f32 to ``csrc/flash_attention.cu``
(f32 FMAs on the CUDA cores).  The plain torch version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the head dims both kernels are built for
HEAD_DIMS = (64, 128, 192)
# dtype -> (library, its C launcher)
_KERNELS = {torch.float32: ("flash_attention", "flash_attention_launch"),
            torch.bfloat16: ("flash_attention_wgmma",
                             "flash_attention_wgmma_launch")}


def _launcher(dtype: torch.dtype):
    lib, name = _KERNELS[dtype]
    fn = getattr(_build.load(lib), name)
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
    fn.restype = _I
    return fn


def flash_attention_fake(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Attention's shape-only implementation for a ``meta`` tensor:
    (BH, Sq, D) in q's dtype, one call recorded."""
    out = torch.empty_like(q)
    _build.record_fake("flash_attention", (q, k, v), (out,))
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, bq: int, bk: int) -> torch.Tensor:
    """Attention of q (BH, Sq, D) over k, v (BH, Sk, D) on the card.

    ``bq`` and ``bk`` are kept for the reference kernel's signature alone:
    the shape rule they stand for is applied by ``ops.flash_attention``,
    and the kernels work in tiles of 64 or 128 queries and 64 keys and
    mask a ragged edge.  D must be 64, 128 or 192; BH, Sq and Sk are at
    least 1; q, k and v share one dtype (f32 or bf16), are contiguous and
    start on 16-byte boundaries."""
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, Sq, D), got shape {tuple(q.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel needs D in {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _KERNELS:
        raise ValueError(f"the flash_attention kernel takes f32 or bf16, got "
                         f"{q.dtype}")
    if min(bh, sq, sk) < 1:
        raise ValueError(f"the flash_attention kernel takes no empty shape, "
                         f"got BH={bh}, Sq={sq}, Sk={sk}")
    if bh > 65535:
        raise ValueError(f"the flash_attention kernel takes BH <= 65535, got "
                         f"{bh}")
    _build.check_tensor(q, "q", q.dtype, q.device)
    _build.check_tensor(k, "k", q.dtype, q.device, (bh, sk, d))
    _build.check_tensor(v, "v", q.dtype, q.device, (bh, sk, d))
    for name, t in (("q", q), ("k", k), ("v", v)):
        # 16-byte vector loads (f32) and TMA (bf16) need aligned rows
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    # both kernels take exponentials base 2 of scores scaled by log2(e)
    scale = float(np.float32(float(np.float32(1.0 / np.sqrt(d)))
                             * math.log2(math.e)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), bh, sq, sk, d, int(causal),
                             scale, stream)
    _build.check(err, _KERNELS[q.dtype][0])
    _build.LAUNCHES["flash_attention"] += 1
    return out
