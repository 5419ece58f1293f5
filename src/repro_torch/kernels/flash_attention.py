"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``:
forward online-softmax attention over (BH, S, D) tensors, causal or not,
scale 1/sqrt(D), f32 or bf16 in, the input type out, f32 inside.  The plain
torch version is :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the head dims the kernel is built for
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
    fn.restype = _I
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, bq: int, bk: int) -> torch.Tensor:
    """Attention of q (BH, Sq, D) over k, v (BH, Sk, D) on the card.

    ``bq`` and ``bk`` are kept for the reference kernel's signature alone:
    the shape rule they stand for is applied by ``ops.flash_attention``,
    and the kernel works in tiles of 64 queries and 64 keys and masks a
    ragged edge.  D must be 64 or 128; BH, Sq and Sk are at least 1; q, k
    and v share one dtype (f32 or bf16) and are contiguous."""
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, Sq, D), got shape {tuple(q.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel needs D in {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _DTYPES:
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
    out = torch.empty_like(q)
    scale = float(np.float32(1.0 / np.sqrt(d)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bh, sq, sk, d, int(causal), scale,
                      _DTYPES[q.dtype], stream)
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
