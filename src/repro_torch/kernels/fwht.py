"""Wrapper of the Walsh-Hadamard CUDA kernel (``csrc/fwht.cu``).

Counterpart of ``repro.kernels.fwht.fwht_pallas``: the normalized FWHT
over the last axis, f32 or bf16 (f32 inside), equal to the plain torch
version :func:`repro_torch.kernels.ref.fwht_ref` bit for bit, for rows of
any power of two.  Rows of at most ``TILE_D`` take one launch of the tile
kernel, rows of up to ``CLUSTER_D`` one launch of the cluster kernel (a
thread-block cluster of d / TILE_D blocks a row); longer rows take the
tile kernel over their low ``TILE_LOG2`` index bits and then one launch per
group of at most ``HIGH_BITS`` of the rest (:func:`fwht_passes`), f32 in
between.  A tensor whose data does not start on a 16-byte boundary takes
the same kernels with one-element loads and stores (the C launcher picks
them from the pointers); nothing is copied.
"""
from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from repro_torch.kernels import _build

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)

# rows of at most TILE_D take one launch of the tile kernel, rows of at
# most CLUSTER_D one of the cluster kernel; each further launch of a longer
# row runs the stages of at most HIGH_BITS index bits
TILE_LOG2 = 14
TILE_D = 1 << TILE_LOG2
CLUSTER_LOG2 = 18
CLUSTER_D = 1 << CLUSTER_LOG2
HIGH_BITS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launchers():
    """The C launchers (whole rows, further passes), loaded and typed once."""
    lib = _build.load("fwht")
    tile, high = lib.fwht_launch, lib.fwht_pass_launch
    tile.argtypes = [_P, _P, _I64, _I, _F, _I, _I, _P]
    high.argtypes = [_P, _P, _I64, _I, _I, _F, _I, _P]
    tile.restype = high.restype = _I
    return tile, high


def fwht_passes(d: int) -> "list[tuple[int, int]]":
    """The further launches of rows of ``d`` (a power of two), as (lowest
    index bit, bits) each: none for d <= CLUSTER_D.  Past it the first
    launch (the tile kernel) runs the low TILE_LOG2 index bits; the rest
    split as evenly as can be into groups of at most HIGH_BITS."""
    log2d = d.bit_length() - 1
    if log2d <= CLUSTER_LOG2:
        return []
    high = log2d - TILE_LOG2
    n = -(-high // HIGH_BITS)
    sizes = [high // n + (i < high % n) for i in range(n)]
    return list(zip(itertools.accumulate([TILE_LOG2] + sizes[:-1]), sizes))


def _check(x: torch.Tensor) -> int:
    d = x.shape[-1]
    if d < 1 or d & (d - 1):
        raise ValueError(f"the fwht kernel needs d a power of two, got {d}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the fwht kernel takes f32 or bf16, got {x.dtype}")
    return d


def _plan(x: torch.Tensor, out: torch.Tensor
          ) -> "list[tuple[torch.Tensor, torch.Tensor, tuple | None]]":
    """The launches of the FWHT of x into ``out``, in order, as (tensor
    read, tensor written, pass): pass None is the tile or the cluster
    kernel over whole rows when it is the only launch, else the tile kernel
    over their low TILE_LOG2 index bits, unscaled, into f32; a pass (lowest
    index bit, bits) is a further launch (:func:`fwht_passes`).  Between
    launches the data is f32: in ``out`` for f32, in a scratch of x's
    shape for bf16."""
    passes = fwht_passes(x.shape[-1])
    if not passes:
        return [(x, out, None)]
    buf = (out if x.dtype == torch.float32
           else torch.empty(x.shape, dtype=torch.float32, device=x.device))
    return [(x, buf, None)] + [(buf, out if i == len(passes) - 1 else buf, p)
                               for i, p in enumerate(passes)]


def fwht_fake(x: torch.Tensor) -> torch.Tensor:
    """The FWHT's shape-only implementation for a ``meta`` tensor: rows as
    given, one call recorded for each launch the card would make, with the
    tensors that launch reads and writes."""
    _check(x)
    out = torch.empty_like(x)
    for src, dst, _ in _plan(x, out):
        _build.record_fake("fwht", (src,), (dst,))
    return out


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """Normalized FWHT of x (..., d) on the card; d any power of two.  One
    launch for d <= CLUSTER_D, 1 + len(fwht_passes(d)) above, each
    counted."""
    d = _check(x)
    _build.check_tensor(x, "x", x.dtype, x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    rows = x.numel() // d
    log2d = d.bit_length() - 1
    scale = float(np.float32(1.0 / np.sqrt(d)))
    stream = _build.current_stream(x.device)
    tile, high = _launchers()
    dt = _DTYPES[x.dtype]
    plan = _plan(x, out)
    for i, (src, dst, p) in enumerate(plan):
        last = i == len(plan) - 1
        if p is None:
            bits = log2d if last else TILE_LOG2
            err = tile(src.data_ptr(), dst.data_ptr(), rows << (log2d - bits),
                       bits, scale, dt, int(not last), stream)
        else:
            err = high(src.data_ptr(), dst.data_ptr(), rows << log2d, *p,
                       scale, dt if last else -1, stream)
        _build.check(err, "fwht")
        _build.LAUNCHES["fwht"] += 1
    return out
