"""Wrapper of the flash-attention CUDA kernels.

Counterpart of ``repro.kernels.flash_attention.flash_attention_pallas``:
forward online-softmax attention over (BH, S, D) tensors, causal or not,
scale 1/sqrt(D), f32, bf16 or f16 in, the input type out, f32 inside.
Which kernel takes a call, by head dim D and input type:

- f32, each f32 product as three TF32 ones on the tensor cores, K/V by
  TMA: up to D 64 ``csrc/flash_attention.cu`` (wgmma; the producer
  warpgroup splits K and V into TF32 hi and lo, V transposed), built for D
  64; above it ``csrc/flash_attention_wide.cu`` (mma.sync, the operands
  split as they are loaded), built for D 128, 192, 256, 384 and 512, past
  512 the output columns in groups of 512 over the grid (each group's
  block computes the scores over all of D).
- bf16 and f16 up to D 256: ``csrc/flash_attention_wgmma.cu`` (wgmma on
  the tensor cores, K/V by TMA, P split into two terms of the input type),
  built for D 16, 32, 64, 128, 192 and 256; up to D 64 a block holds
  more consumer warpgroups (:func:`wgmma_residency`).
- bf16 and f16 in (256, 512]: ``csrc/flash_attention_wgmma_wide.cu`` (the
  same numerics, the D columns split between two consumer warpgroups that
  share each score), built for D 384 and 512; past 512 the f32 kernel's
  library, in groups of 512 output columns.
- any type up to D 256 with at most ``SPLIT_MAX_SQ`` queries and no causal
  mask: ``csrc/flash_attention_split.cu`` (mma.sync, the keys split over
  the grid by :func:`split_plan`, each block's partial softmax merged by
  the last block of its row), built for the head dims above.

Any other D is padded with zero columns to the next head dim built for
its type (:func:`padded_head_dim`), one launch at the unpadded D's scale.
The plain torch version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the head dims the bf16 and f16 kernels are built for: up to 256
# (MAX_HEAD_DIM) the wgmma kernel, then the wide ones; past the last,
# multiples of GROUP.  f32 takes F32_HEAD_DIMS (up to F32_WGMMA_HEAD_DIM
# the wgmma TF32 kernel, then the mma.sync one) and past them the same
# multiples of GROUP
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
MAX_HEAD_DIM = HEAD_DIMS[-1]
WIDE_HEAD_DIMS = (384, 512)
GROUP = WIDE_HEAD_DIMS[-1]
F32_WGMMA_HEAD_DIM = 64
F32_HEAD_DIMS = (64, 128, 192, 256) + WIDE_HEAD_DIMS
# dtype -> (library, its C launcher), head dims up to MAX_HEAD_DIM (f32:
# up to F32_WGMMA_HEAD_DIM)
_KERNELS = {torch.float32: ("flash_attention", "flash_attention_launch"),
            torch.bfloat16: ("flash_attention_wgmma",
                             "flash_attention_wgmma_launch"),
            torch.float16: ("flash_attention_wgmma",
                            "flash_attention_wgmma_f16_launch")}
# calls of at most SPLIT_MAX_SQ query rows, not causal, up to MAX_HEAD_DIM
SPLIT_MAX_SQ = 16
SPLIT_LIB = "flash_attention_split"
_SPLIT = {torch.float32: (SPLIT_LIB, "flash_attention_split_launch"),
          torch.bfloat16: (SPLIT_LIB, "flash_attention_split_bf16_launch"),
          torch.float16: (SPLIT_LIB, "flash_attention_split_f16_launch")}
# the split plan: about SPLIT_BLOCKS_PER_SM blocks an SM in all (f32, with
# three TF32 products a key, two; on an H100 more splits, or a block count
# that is no multiple of the SMs, were slower: each split adds a partial
# to merge), no more than fit at once, at least SPLIT_MIN_KEYS keys a
# split; the kernel's own limits come from its library (_split_limits)
SPLIT_BLOCKS_PER_SM = {torch.float32: 2, torch.bfloat16: 1, torch.float16: 1}
SPLIT_MIN_KEYS = 256
# the split kernel's codes of the input types
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the same for head dims in (MAX_HEAD_DIM, GROUP]
_WIDE = {torch.float32: ("flash_attention_wide",
                         "flash_attention_wide_launch"),
         torch.bfloat16: ("flash_attention_wgmma_wide",
                          "flash_attention_wgmma_wide_launch"),
         torch.float16: ("flash_attention_wgmma_wide",
                         "flash_attention_wgmma_wide_f16_launch")}
# and past GROUP, in groups of GROUP output columns
_GROUPED = {torch.float32: ("flash_attention_wide",
                            "flash_attention_wide_launch"),
            torch.bfloat16: ("flash_attention_wide",
                             "flash_attention_wide_bf16_launch"),
            torch.float16: ("flash_attention_wide",
                            "flash_attention_wide_f16_launch")}


def kernel_of(dtype: torch.dtype, d: int, sq: "int | None" = None,
              causal: bool = True) -> "tuple[str, str]":
    """(library, C launcher) that attention of ``dtype`` at head dim ``d``
    launches: with ``sq`` <= SPLIT_MAX_SQ query rows and not ``causal``,
    up to MAX_HEAD_DIM, the split kernel (for any Sk: :func:`split_plan`
    gives one split where BH alone fills the card), else by ``d``."""
    if sq is not None and sq <= SPLIT_MAX_SQ and not causal \
            and d <= MAX_HEAD_DIM:
        return _SPLIT[dtype]
    if d <= (F32_WGMMA_HEAD_DIM if dtype == torch.float32 else MAX_HEAD_DIM):
        return _KERNELS[dtype]
    return (_WIDE if d <= GROUP else _GROUPED)[dtype]


def split_plan(bh: int, sk: int, blocks: int, max_splits: int,
               align: int) -> "tuple[int, int]":
    """(splits, keys a split) of the split kernel over ``bh`` rows of ``sk``
    keys for about ``blocks`` blocks in all: as many splits as make at most
    that many (one where ``bh`` alone does), none shorter than
    SPLIT_MIN_KEYS (but one) nor more than ``max_splits``; the keys a split
    rounded up to a multiple of ``align``, and the splits recounted so that
    none is empty."""
    want = max(1, blocks // bh)
    splits = max(1, min(want, -(-sk // SPLIT_MIN_KEYS), max_splits))
    per = -(-sk // splits)
    kps = -(-per // align) * align
    return -(-sk // kps), kps


@functools.cache
def _split_limits(dtype: torch.dtype, d: int, index: int
                  ) -> "tuple[int, int, int]":
    """(blocks to aim at, most splits, key alignment) of the split kernel
    at (``dtype``, built head dim ``d``) on card ``index``, the arguments
    of :func:`split_plan` after Sk: SPLIT_BLOCKS_PER_SM of its type on each
    SM, or as many as fit there at once where fewer do; the other two as
    the library states them."""
    fn = _build.load(SPLIT_LIB).flash_attention_split_limits
    fn.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 3
    fn.restype = _I
    blocks, max_splits, align = _I(0), _I(0), _I(0)
    with torch.cuda.device(index):
        _build.check(fn(_DTYPE_CODES[dtype], d, ctypes.byref(blocks),
                        ctypes.byref(max_splits), ctypes.byref(align)),
                     SPLIT_LIB)
    props = torch.cuda.get_device_properties(index)
    return (min(SPLIT_BLOCKS_PER_SM[dtype], blocks.value)
            * props.multi_processor_count, max_splits.value, align.value)


@functools.cache
def wgmma_residency(dtype: torch.dtype, d: int, index: int
                    ) -> "tuple[int, int, int]":
    """(blocks resident on one SM, consumer warpgroups a block, registers
    a thread) of the bf16/f16 wgmma kernel's instance at (``dtype``, built
    head dim ``d``) on card ``index``, as its library states them.  Raises
    for another dtype or head dim before it loads the library."""
    if dtype not in (torch.bfloat16, torch.float16) or d not in HEAD_DIMS:
        raise ValueError(f"the wgmma kernel is built for bf16 and f16 at "
                         f"head dims {HEAD_DIMS}, not {dtype} at {d}")
    lib = _KERNELS[dtype][0]
    fn = _build.load(lib).flash_attention_wgmma_residency
    fn.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 3
    fn.restype = _I
    blocks, consumers, regs = _I(0), _I(0), _I(0)
    with torch.cuda.device(index):
        _build.check(fn(int(dtype == torch.float16), d, ctypes.byref(blocks),
                        ctypes.byref(consumers), ctypes.byref(regs)), lib)
    return blocks.value, consumers.value, regs.value


# each (device, stream)'s scratch and counters of the split kernel: the
# calls on one stream run in order, and the kernel leaves the counters 0
_WORKSPACE: "dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]]" = {}


def _split_workspace(device: torch.device, stream: int, n_part: int,
                     n_count: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """f32 scratch of at least ``n_part`` and zeroed int32 counters of at
    least ``n_count`` elements for a split launch on ``stream``."""
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < n_part or ws[1].numel() < n_count:
        n_part = max(n_part, ws[0].numel() if ws else 0)
        n_count = max(n_count, ws[1].numel() if ws else 0)
        ws = _WORKSPACE[key] = (
            torch.empty(n_part, dtype=torch.float32, device=device),
            torch.zeros(n_count, dtype=torch.int32, device=device))
    return ws


@functools.cache
def _scale_log2(d: int) -> float:
    """f32(1/sqrt(d)) * log2(e) in f32: the kernels take exponentials base
    2 of scores scaled by log2(e)."""
    return float(np.float32(float(np.float32(1.0 / np.sqrt(d)))
                            * math.log2(math.e)))


@functools.cache
def _launcher(lib: str, name: str):
    """The C launcher ``name`` of library ``lib``, loaded and typed once."""
    fn = getattr(_build.load(lib), name)
    # (q, k, v, out, [part, counter,] bh, sq, sk, d, causal | splits, kps,
    # scale_log2, stream)
    fn.argtypes = ([_P] * 6 + [_I] * 6 + [_F, _P] if lib == SPLIT_LIB
                   else [_P] * 4 + [_I] * 5 + [_F, _P])
    fn.restype = _I
    return fn


def padded_head_dim(d: int, dtype: torch.dtype) -> int:
    """The built head dim that a head dim of ``d`` >= 1 in ``dtype`` runs
    at: the next of ``HEAD_DIMS`` and ``WIDE_HEAD_DIMS`` (f32: of
    ``F32_HEAD_DIMS``), past the last the next multiple of ``GROUP``."""
    if d > GROUP:
        return -(-d // GROUP) * GROUP
    built = (F32_HEAD_DIMS if dtype == torch.float32
             else HEAD_DIMS + WIDE_HEAD_DIMS)
    return next(w for w in built if w >= d)


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """q, k and v with zero columns appended up to :func:`padded_head_dim`
    of q's dtype (the same tensors where D is built).  The zeros add exact
    zeros to every q.k and give zero output columns, so attention of the
    padded tensors at the scale of the unpadded D, sliced back to D
    columns, is attention of the unpadded ones."""
    d = q.shape[-1]
    dp = padded_head_dim(d, q.dtype)
    if dp == d:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))


def flash_attention_fake(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Attention's shape-only implementation for a ``meta`` tensor:
    (BH, Sq, D) in q's dtype, one call recorded."""
    out = torch.empty_like(q)
    _build.record_fake("flash_attention", (q, k, v), (out,))
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, bq: int, bk: int) -> torch.Tensor:
    """Attention of q (BH, Sq, D) over k, v (BH, Sk, D) on the card, in one
    kernel launch (:func:`kernel_of`).

    ``bq`` and ``bk`` are kept for the reference kernel's signature alone:
    the kernels work in tiles of 16 to 128 queries and 8 to 128 keys and
    mask a ragged edge, so BH, Sq and Sk may be any sizes of at least 1.  A
    D that the kernels are not built for is padded with zero columns
    (:func:`pad_head_dim`) and the output sliced back.  q, k and v share
    one dtype (f32, bf16 or f16), are contiguous and start on 16-byte
    boundaries."""
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, Sq, D), got shape {tuple(q.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _KERNELS:
        raise ValueError(f"the flash_attention kernel takes f32, bf16 or "
                         f"f16, got {q.dtype}")
    if min(bh, sq, sk, d) < 1:
        raise ValueError(f"the flash_attention kernel takes no empty shape, "
                         f"got BH={bh}, Sq={sq}, Sk={sk}, D={d}")
    _build.check_tensor(q, "q", q.dtype, q.device)
    _build.check_tensor(k, "k", q.dtype, q.device, (bh, sk, d))
    _build.check_tensor(v, "v", q.dtype, q.device, (bh, sk, d))
    for name, t in (("q", q), ("k", k), ("v", v)):
        # TMA needs rows on 16-byte boundaries
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    qp, kp, vp = pad_head_dim(q, k, v)
    out = torch.empty_like(qp)
    # the scale is the unpadded D's
    scale = _scale_log2(d)
    stream = _build.current_stream(q.device)
    lib, name = kernel_of(q.dtype, d, sq, causal)
    dp = qp.shape[-1]
    if lib == SPLIT_LIB:
        splits, kps = split_plan(
            bh, sk, *_split_limits(q.dtype, dp, q.device.index))
        part = cnt = None
        if splits > 1:
            part, cnt = _split_workspace(
                q.device, stream, bh * splits * sq * (dp + 2), bh)
        err = _launcher(lib, name)(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None,
            cnt.data_ptr() if cnt is not None else None, bh, sq, sk, dp,
            splits, kps, scale, stream)
    else:
        err = _launcher(lib, name)(qp.data_ptr(), kp.data_ptr(),
                                   vp.data_ptr(), out.data_ptr(), bh, sq, sk,
                                   dp, int(causal), scale, stream)
    _build.check(err, lib)
    _build.LAUNCHES["flash_attention"] += 1
    return out if out.shape[-1] == d else out[..., :d].contiguous()
