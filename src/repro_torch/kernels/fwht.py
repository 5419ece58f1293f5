"""Wrapper of the Walsh-Hadamard CUDA kernel (``csrc/fwht.cu``).

Counterpart of ``repro.kernels.fwht.fwht_pallas``: the normalized FWHT
over the last axis, f32 or bf16 (f32 inside), equal to the plain torch
version :func:`repro_torch.kernels.ref.fwht_ref` bit for bit, for rows of
any power of two.  Rows of at most ``TILE_D`` take one launch of the tile
kernel, rows of up to ``CLUSTER_D`` one launch of the cluster kernel (a
thread-block cluster of d / TILE_D blocks a row), rows of up to
``FUSED_D`` one launch of the fused kernel (items of the tile kernel over
the low index bits and items of the high bits in one grid, in the order of
a ticket, the intermediate f32 kept in L2); longer rows take the fused
kernel over segments of 2^20 to ``FUSED_D`` and then one launch per group
of at most ``HIGH_BITS`` of the rest (:func:`fwht_passes`), f32 in
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
# most CLUSTER_D one of the cluster kernel, rows of at most FUSED_D one of
# the fused kernel; longer rows start with the fused kernel over segments
# of 2^SEGMENT_LOG2 to FUSED_D, and each further launch runs the stages of
# at most HIGH_BITS index bits
TILE_LOG2 = 14
TILE_D = 1 << TILE_LOG2
CLUSTER_LOG2 = 18
CLUSTER_D = 1 << CLUSTER_LOG2
FUSED_LOG2 = 22
FUSED_D = 1 << FUSED_LOG2
SEGMENT_LOG2 = 20
HIGH_BITS = 8
# the fused kernel's high items of row r come after its low items of row r
# + FUSED_LAG[log2 d] (of a segment past FUSED_D), so that the f32 rows
# between the two stay in L2 (8-32 MiB); bf16 output keeps its f32 rows in
# a ring of lag + RING_EXTRA slots.  Both the fastest of a sweep on an H100
# (``scripts/fwht_rows_time.py --sweep``)
FUSED_LAG = {19: 4, 20: 3, 21: 1, 22: 1}
RING_EXTRA = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _launchers():
    """The C launchers (whole rows, further passes), loaded and typed once."""
    lib = _build.load("fwht")
    tile, high = lib.fwht_launch, lib.fwht_pass_launch
    tile.argtypes = [_P, _P, _I64, _I, _F, _I, _I, _P, _P, _I, _I, _P]
    high.argtypes = [_P, _P, _I64, _I, _I, _F, _I, _P]
    tile.restype = high.restype = _I
    return tile, high


def fwht_passes(d: int) -> "list[tuple[int, int]]":
    """The further launches of rows of ``d`` (a power of two), as (lowest
    index bit, bits) each: none for d <= FUSED_D.  Past it the first
    launch (the fused kernel over segments of 2^g) runs the low g index
    bits, g the least of SEGMENT_LOG2 .. FUSED_LOG2 that leaves at most
    HIGH_BITS (the fused kernel is slowest at FUSED_D); the rest split as
    evenly as can be into groups of at most HIGH_BITS."""
    log2d = d.bit_length() - 1
    if log2d <= FUSED_LOG2:
        return []
    first = min(FUSED_LOG2, max(SEGMENT_LOG2, log2d - HIGH_BITS))
    high = log2d - first
    n = -(-high // HIGH_BITS)
    sizes = [high // n + (i < high % n) for i in range(n)]
    return list(zip(itertools.accumulate([first] + sizes[:-1]), sizes))


def ring_slots(d: int, rows: int) -> int:
    """f32 rows of d in the fused kernel's ring for bf16 output of ``rows``
    rows: one a row when no slot would be reused, else lag + RING_EXTRA."""
    return min(rows, FUSED_LAG[d.bit_length() - 1] + RING_EXTRA)


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
    read, tensor written, pass): pass None is the tile, cluster or fused
    kernel over whole rows when it is the only launch, else the fused
    kernel over segments below the first pass's bit, unscaled, into f32; a
    pass (lowest index bit, bits) is a further launch
    (:func:`fwht_passes`).  Between
    launches the data is f32: in ``out`` for f32, in a scratch of x's
    shape for bf16."""
    passes = fwht_passes(x.shape[-1])
    if not passes:
        return [(x, out, None)]
    buf = (out if x.dtype == torch.float32
           else torch.empty(x.shape, dtype=torch.float32, device=x.device))
    return [(x, buf, None)] + [(buf, out if i == len(passes) - 1 else buf, p)
                               for i, p in enumerate(passes)]


def _needs_ring(x: torch.Tensor) -> bool:
    """Whether the launch over whole rows of x is the fused kernel writing
    bf16, which keeps its f32 rows in a ring."""
    d = x.shape[-1]
    return x.dtype == torch.bfloat16 and CLUSTER_D < d <= FUSED_D


def fwht_fake(x: torch.Tensor) -> torch.Tensor:
    """The FWHT's shape-only implementation for a ``meta`` tensor: rows as
    given, one call recorded for each launch the card would make, with the
    tensors that launch reads and writes (the fused kernel's ring among
    them)."""
    d = _check(x)
    out = torch.empty_like(x)
    for src, dst, _ in _plan(x, out):
        outs = (dst,)
        if src is x and dst is out and _needs_ring(x):
            rows = x.numel() // d
            outs += (torch.empty((ring_slots(d, rows), d),
                                 dtype=torch.float32, device=x.device),)
        _build.record_fake("fwht", (src,), outs)
    return out


# each (device, stream)'s counters and ring of the fused kernel: the calls
# on one stream run in order, and the kernel leaves the counters 0
_WORKSPACE: "dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor | None]]" = {}


def _fused_workspace(device: torch.device, stream: int, n_sync: int,
                     n_ring: int) -> "tuple[torch.Tensor, torch.Tensor | None]":
    """Zeroed int32 counters of at least ``n_sync`` words and an f32 ring
    of at least ``n_ring`` elements (none if 0) for a fused launch on
    ``stream``."""
    key = (device.index, stream)
    sync, ring = _WORKSPACE.get(key, (None, None))
    if sync is None or sync.numel() < n_sync:
        sync = torch.zeros(max(n_sync, sync.numel() if sync is not None
                               else 0), dtype=torch.int32, device=device)
    if n_ring and (ring is None or ring.numel() < n_ring):
        ring = torch.empty(n_ring, dtype=torch.float32, device=device)
    _WORKSPACE[key] = (sync, ring)
    return sync, ring


def fwht_cuda(x: torch.Tensor) -> torch.Tensor:
    """Normalized FWHT of x (..., d) on the card; d any power of two.  One
    launch for d <= FUSED_D, 1 + len(fwht_passes(d)) above, each
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
            bits = log2d if last else plan[1][2][0]
            segs = rows << (log2d - bits)
            ring = sync = None
            lag = slots = 0
            if bits > CLUSTER_LOG2:
                lag = FUSED_LAG[bits]
                slots = ring_slots(d, rows) if _needs_ring(x) else 0
                sync, ring = _fused_workspace(x.device, stream,
                                              2 + 2 * segs, slots * d)
            err = tile(src.data_ptr(), dst.data_ptr(), segs, bits, scale, dt,
                       int(not last),
                       None if ring is None else ring.data_ptr(),
                       None if sync is None else sync.data_ptr(), lag, slots,
                       stream)
        else:
            err = high(src.data_ptr(), dst.data_ptr(), rows << log2d, *p,
                       scale, dt if last else -1, stream)
        _build.check(err, "fwht")
        _build.LAUNCHES["fwht"] += 1
    return out
