"""Sharding context and parameter metadata; counterpart of
``repro.models.sharding``.

Parameter storage layout (ZeRO-3), as the reference's: each logical leaf
has a TP-local shape ``local_shape``; it is stored flat, padded, and
sharded over the DP ranks:

    global array:   (L?, T, P, shard_len)   (L only for layer stacks)
    a rank's slice: (L?, 1, 1, shard_len)

The port stores only the rank's slice.  Inside a layer :func:`gather_param`
runs the FSDP gather (``dist/fsdp.py``): the forward all-gathers bf16
weights over the DP process groups, the backward reduce-scatters the
gradient with the paper's lattice quantization.

Tensor parallelism is not ported: ``ShardCtx(tp > 1)`` raises, and the TP
helpers at the end of this module are the identities they are at tp = 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch import resolve_device
from repro_torch.dist import fsdp as F
from repro_torch.dist.collectives import QSyncConfig


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Static parallelism context threaded through every model function.

    dp_axes: the DP process groups, outermost first (``None``: the default
    group); tp must be 1, so the reference's TP fields (``tp_axis``,
    ``quantize_tp_grads``, ``seq_parallel``) have no counterpart."""
    dp_axes: tuple = (None,)
    tp: int = 1
    dp: int = 1                       # product of the DP group sizes
    qcfg: QSyncConfig = QSyncConfig()
    grad_sync: str = "lq"             # "lq" | "fp32"
    gather_dtype: str = "bfloat16"
    remat: bool = True
    anchor_grads: bool = False        # anchored DP sync (butterfly on
                                      # g - previous step's decoded mean)
    anchor_sharded: bool = True       # anchored: anchors stored like w
    prefetch: bool = False            # issue layer k+1's gather while layer
                                      # k computes (bit-identical to serial)

    def __post_init__(self):
        if self.tp != 1:
            raise NotImplementedError(
                f"tensor parallelism (tp={self.tp}) is not ported yet; see "
                f"ROADMAP.md section 1")
        if self.anchor_grads and self.grad_sync != "lq":
            raise ValueError("anchor_grads requires grad_sync='lq'")

    def fsdp_config(self) -> F.FSDPConfig:
        return F.FSDPConfig(axes=self.dp_axes, qcfg=self.qcfg,
                            sync=self.grad_sync, gather_dtype=self.gather_dtype,
                            anchored=self.anchor_grads,
                            anchor_sharded=self.anchor_sharded)


# ---------------------------------------------------------------------------
# Parameter metadata
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafMeta:
    """Static description of one parameter leaf (the reference's fields:
    TP-local shape, sliced dim, stacked over layers, initializer)."""
    local_shape: tuple
    tp_dim: Optional[int] = None
    scanned: bool = True
    init: str = "normal"
    init_scale: float = 1.0
    tp_repl: int = 1

    @property
    def tp_replicated(self) -> bool:
        return self.tp_dim is None

    def numel(self) -> int:
        return int(np.prod(self.local_shape))


def effective_bucket(n: int, ctx: ShardCtx) -> int:
    """Bucket size for quantized RS, shrunk for small leaves."""
    b = ctx.qcfg.bucket
    while b > 32 and n < ctx.dp * b:
        b //= 2
    return b


def shard_len(meta: LeafMeta, ctx: ShardCtx) -> int:
    """Flat per-rank length (padded to dp*bucket granularity)."""
    n = meta.numel()
    return F.pad_to_shardable(n, ctx.dp, effective_bucket(n, ctx)) // ctx.dp


def leaf_gathered_len(meta: LeafMeta, ctx: ShardCtx) -> int:
    """Flat gathered length of one leaf (dp * shard_len)."""
    return shard_len(meta, ctx) * ctx.dp


def leaf_nb(meta: LeafMeta, ctx: ShardCtx) -> int:
    """Bucket count of one leaf's DP gradient sync (per-bucket y length)."""
    return F.leaf_nb(leaf_gathered_len(meta, ctx), ctx.dp, ctx.qcfg)


def leaf_anchor_len(meta: LeafMeta, ctx: ShardCtx) -> int:
    """Anchor length one leaf's y-state stores: the rank's shard (sharded),
    the gathered length (replicated), 0 unanchored."""
    if not ctx.anchor_grads:
        return 0
    return (shard_len(meta, ctx) if ctx.anchor_sharded
            else leaf_gathered_len(meta, ctx))


def leaf_tele_width(meta: LeafMeta, ctx: ShardCtx) -> int:
    """Tele-leaf length: scalars + per-bucket maps (+ anchor when anchored)."""
    return F.tele_width(leaf_nb(meta, ctx), leaf_anchor_len(meta, ctx),
                        ctx.anchor_grads)


def anchor_shape(meta: LeafMeta, ctx: ShardCtx, n_layers: int = 0) -> tuple:
    """Global shape of one leaf's anchor state: ``(tp, dp, shard_len)``
    sharded (a rank holds ``(1, 1, shard_len)`` of it), ``(m,)``
    replicated; ``n_layers > 0`` prepends the layer dim."""
    if ctx.anchor_sharded:
        s: tuple = (ctx.tp, ctx.dp, shard_len(meta, ctx))
    else:
        s = (leaf_gathered_len(meta, ctx),)
    return ((n_layers,) + s) if n_layers else s


def leaf_y0(meta: LeafMeta, ctx: ShardCtx, value: float) -> float:
    """Initial distance bound for one leaf's quantized gradient sync: the
    guess itself, or with ``qcfg.rotate`` the paper's §6 rotated-space
    bound for the l2 distance the guess implies for a bucket."""
    if not ctx.qcfg.rotate:
        return value
    from repro_torch.core import rotation as R
    b = effective_bucket(meta.numel(), ctx)
    return R.rotated_coord_bound(value * math.sqrt(b), b)


def storage_shape(meta: LeafMeta, ctx: ShardCtx, n_layers: int) -> tuple:
    """Global storage shape of one leaf (the reference's)."""
    s = (ctx.tp, ctx.dp, shard_len(meta, ctx))
    return ((n_layers,) + s) if meta.scanned else s


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _f32(x: float) -> float:
    """A Python float rounded to f32 (jax multiplies by it in f32)."""
    return float(np.float32(x))


def init_leaf(key, meta: LeafMeta, ctx: ShardCtx, n_layers: int, *,
              dp_rank: Optional[int] = None, device=None) -> torch.Tensor:
    """Initialize one leaf's storage, as the reference's ``init_leaf``
    draws it: the global ``(L?, 1, dp, shard_len)`` array, or with
    ``dp_rank`` that rank's ``(L?, 1, 1, shard_len)`` slice, drawing only
    the slice's elements (each draw is partitionable)."""
    device = resolve_device(device)
    L = n_layers if meta.scanned else 1
    sl = shard_len(meta, ctx)
    n = meta.numel()
    c0, c1 = (0, ctx.dp * sl) if dp_rank is None else \
        (dp_rank * sl, (dp_rank + 1) * sl)
    span = (min(c0, n), min(c1, n))          # the drawn part of [c0, c1)

    def one(k) -> torch.Tensor:               # flat [c0, c1) of one layer
        if meta.init == "zeros":
            flat = torch.zeros(span[1] - span[0], device=device)
        elif meta.init == "ones":
            flat = torch.ones(span[1] - span[0], device=device)
        elif meta.init == "a_log":
            flat = torch.log(_random.uniform(k, (1, n), 1.0, 16.0,
                                             device=device, span=span))
        elif meta.init == "dt_bias":
            dt = _random.uniform(k, (1, n), 1e-3, 1e-1, device=device,
                                 span=span)
            flat = dt + torch.log(-torch.expm1(-dt))
        elif meta.init == "embed":
            flat = (_random.normal(k, (1, n), device=device, span=span)
                    * _f32(meta.init_scale)) * _f32(0.02)
        else:
            scale = meta.init_scale / math.sqrt(max(meta.local_shape[0], 1))
            flat = _random.normal(k, (1, n), device=device,
                                  span=span) * _f32(scale)
        return torch.nn.functional.pad(flat, (0, (c1 - c0) - flat.shape[0]))

    keys = _random.split(key, L)
    out = torch.stack([one(k) for k in keys])          # (L, c1 - c0)
    out = out.reshape(L, 1, (c1 - c0) // sl, sl)
    return out if meta.scanned else out[0]


# ---------------------------------------------------------------------------
# Logical <-> storage converters (checkpoints, elastic re-sharding, tests)
# ---------------------------------------------------------------------------

def logical_to_storage(x, meta: LeafMeta, ctx: ShardCtx) -> torch.Tensor:
    """One logical layer tensor -> (1, dp, shard_len) storage layout."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n = meta.numel()
    sl = shard_len(meta, ctx)
    flat = torch.nn.functional.pad(x.reshape(1, n), (0, ctx.dp * sl - n))
    return flat.reshape(1, ctx.dp, sl)


def storage_to_logical(st, meta: LeafMeta, ctx: ShardCtx) -> torch.Tensor:
    """(1, dp, shard_len) storage -> one logical layer tensor."""
    st = torch.as_tensor(st)
    return st.reshape(-1)[:meta.numel()].reshape(meta.local_shape)


# ---------------------------------------------------------------------------
# The gather: storage -> usable weight (per layer)
# ---------------------------------------------------------------------------

def make_gathers(ctx: ShardCtx):
    """The FSDP gather of every leaf.  (The reference returns three, two of
    them adding the TP psum of replicated leaves' gradients; at tp = 1 all
    three are this one.)"""
    return F.make_fsdp_gather(ctx.fsdp_config())


def gather_param(storage: torch.Tensor, meta: LeafMeta, ctx: ShardCtx,
                 y, key, tele: torch.Tensor, gathers,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """A rank's storage slice (1, 1, shard) -> the full weight.

    y: this leaf's distance-bound state (() or (nb,) f32, or {"y", "anchor"}
    anchored); tele: (leaf_tele_width,) zeros requiring grad, whose gradient
    carries back the per-bucket decode telemetry."""
    bundle = {"w": storage.reshape(-1), "y": y, "key": key, "tele": tele}
    w_full = gathers(bundle)
    n = meta.numel()
    return w_full[:n].reshape(meta.local_shape).to(compute_dtype)


def make_split_gathers(ctx: ShardCtx):
    """``(gather_async, wait)`` for the prefetching layer loop."""
    return F.make_fsdp_gather_split(ctx.fsdp_config())


def gather_param_async(storage: torch.Tensor, meta: LeafMeta, ctx: ShardCtx,
                       y, key, tele: torch.Tensor, split) -> F.GatherHandle:
    """Issue one leaf's FSDP all-gather; returns the in-flight handle."""
    gather_async, _ = split
    bundle = {"w": storage.reshape(-1), "y": y, "key": key, "tele": tele}
    return gather_async(bundle)


def gather_param_wait(handle: F.GatherHandle, meta: LeafMeta, ctx: ShardCtx,
                      split, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Consume a prefetched handle -> the full weight."""
    _, wait = split
    w_full = wait(handle)
    n = meta.numel()
    return w_full[:n].reshape(meta.local_shape).to(compute_dtype)


# ---------------------------------------------------------------------------
# TP collective helpers: the identities at tp = 1
# ---------------------------------------------------------------------------

def psum_tp(x, ctx: ShardCtx):
    return x


def pmax_tp(x, ctx: ShardCtx):
    return x


def all_gather_tp(x, ctx: ShardCtx, axis: int = 0):
    return x


def reduce_scatter_tp(x, ctx: ShardCtx, axis: int = 0):
    return x


def tp_index(ctx: ShardCtx) -> int:
    return 0
