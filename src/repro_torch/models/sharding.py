"""Sharding context and parameter metadata; counterpart of
``repro.models.sharding``.

Every model is written manually sharded, as the reference's: tensor
parallel over the TP process group (``ShardCtx.tp_axis``), data parallel
and ZeRO-3 over the DP process groups (``ShardCtx.dp_axes``).

Parameter storage layout (ZeRO-3), as the reference's: each logical leaf
has a TP-local shape ``local_shape`` (already sliced over TP when
``tp_dim`` is set); it is stored flat, padded, and sharded over the DP
ranks:

    global array:   (L?, T, P, shard_len)   (L only for layer stacks)
    a rank's slice: (L?, 1, 1, shard_len)   (its TP index, its DP index)

The port stores only the rank's slice.  Inside a layer :func:`gather_param`
runs the FSDP gather (``dist/fsdp.py``): the forward all-gathers bf16
weights over the DP process groups, the backward reduce-scatters the
gradient with the paper's lattice quantization.  ``tp_replicated`` leaves
(KV projections when kv_heads < tp, norm scales) hold the same values on
every TP rank; their backward psums the gradient over TP (optionally
through the quantized butterfly, ``quantize_tp_grads``) before the DP
reduce-scatter.

The TP collectives (:func:`psum_tp`, :func:`all_gather_tp`,
:func:`reduce_scatter_tp`, :func:`all_to_all_tp`) are autograd functions
whose backward is the reference's pinned transpose: psum -> psum,
all-gather -> reduce-scatter-sum, reduce-scatter -> all-gather,
all-to-all -> the reverse all-to-all.  Every sum adds the
ranks' terms in rank order, so each rank holds the same bits; XLA's
order for ``psum`` and ``psum_scatter`` is not pinned, so a sum of more
than two terms may differ from the reference's by rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as _random
from repro_torch import resolve_device
from repro_torch.dist import collectives as C
from repro_torch.dist import fsdp as F
from repro_torch.dist.collectives import (QSyncConfig, butterfly_allreduce_mean,
                                          flat_size_padded)

# Seed of the shared dither used by the quantized TP gradient psum (every
# rank derives the same offsets without communication, like the
# collectives' rotation seed).
_TP_SYNC_SEED = 20210508


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Static parallelism context threaded through every model function.

    tp_axis: the TP process group (``None``: the default group); dp_axes:
    the DP process groups, outermost first (``None``: the default group).
    ``launch/mesh.mesh_axes`` builds both from a (dp..., tp) layout."""
    tp_axis: object = None
    dp_axes: tuple = (None,)
    tp: int = 1                       # size of the TP group
    dp: int = 1                       # product of the DP group sizes
    qcfg: QSyncConfig = QSyncConfig()
    grad_sync: str = "lq"             # "lq" | "fp32"
    quantize_tp_grads: bool = False   # butterfly-quantize the TP psum of
                                      # replicated leaves' gradients
    gather_dtype: str = "bfloat16"
    seq_parallel: bool = False        # residual stream sharded over tp
    remat: bool = True
    anchor_grads: bool = False        # anchored DP sync (butterfly on
                                      # g - previous step's decoded mean)
    anchor_sharded: bool = True       # anchored: anchors stored like w
    prefetch: bool = False            # issue layer k+1's gather while layer
                                      # k computes (bit-identical to serial)

    def __post_init__(self):
        if self.anchor_grads and self.grad_sync != "lq":
            raise ValueError("anchor_grads requires grad_sync='lq'")
        if self.tp > 1 and dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if world % self.tp:
                raise ValueError(f"tp={self.tp} does not divide the world "
                                 f"of {world} ranks")
            if dist.get_world_size(self.tp_axis) != self.tp:
                raise ValueError(
                    f"tp={self.tp} but the TP group holds "
                    f"{dist.get_world_size(self.tp_axis)} ranks")

    @property
    def world(self) -> int:
        return self.tp * self.dp

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
              dp_rank: Optional[int] = None, tp_rank: int = 0,
              device=None) -> torch.Tensor:
    """Initialize one leaf's storage, as the reference's ``init_leaf``
    draws it: one ``(rows, n)`` draw per layer, ``rows`` the leaf's
    distinct TP shards (1 when replicated), row ``t // tp_repl`` going to
    TP rank t.  Returns the global ``(L?, tp, dp, shard_len)`` array, or
    with ``dp_rank`` the ``(L?, 1, 1, shard_len)`` slice of TP rank
    ``tp_rank`` and DP rank ``dp_rank``, drawing only the slice's elements
    (each draw is partitionable: element (r, j) is the same number however
    much of the draw is taken)."""
    device = resolve_device(device)
    L = n_layers if meta.scanned else 1
    sl = shard_len(meta, ctx)
    n = meta.numel()
    rows = 1 if meta.tp_replicated else ctx.tp // meta.tp_repl
    c0, c1 = (0, ctx.dp * sl) if dp_rank is None else \
        (dp_rank * sl, (dp_rank + 1) * sl)
    tps = range(ctx.tp) if dp_rank is None else (tp_rank,)

    def draw(k, r) -> torch.Tensor:          # flat [c0, c1) of row r
        span = (r * n + min(c0, n), r * n + min(c1, n))
        m = span[1] - span[0]
        if meta.init == "zeros":
            flat = torch.zeros(m, device=device)
        elif meta.init == "ones":
            flat = torch.ones(m, device=device)
        elif meta.init == "a_log":
            flat = torch.log(_random.uniform(k, (rows, n), 1.0, 16.0,
                                             device=device, span=span))
        elif meta.init == "dt_bias":
            dt = _random.uniform(k, (rows, n), 1e-3, 1e-1, device=device,
                                 span=span)
            flat = dt + torch.log(-torch.expm1(-dt))
        elif meta.init == "embed":
            flat = (_random.normal(k, (rows, n), device=device, span=span)
                    * _f32(meta.init_scale)) * _f32(0.02)
        else:
            scale = meta.init_scale / math.sqrt(max(meta.local_shape[0], 1))
            flat = _random.normal(k, (rows, n), device=device,
                                  span=span) * _f32(scale)
        return torch.nn.functional.pad(flat, (0, (c1 - c0) - m))

    def one(k) -> torch.Tensor:               # (len(tps), c1 - c0)
        by_row: dict = {}
        out = []
        for t in tps:
            r = 0 if meta.tp_replicated else t // meta.tp_repl
            if r not in by_row:
                by_row[r] = draw(k, r)
            out.append(by_row[r])
        return torch.stack(out)

    keys = _random.split(key, L)
    out = torch.stack([one(k) for k in keys])      # (L, tps, c1 - c0)
    out = out.reshape(L, len(tps), (c1 - c0) // sl, sl)
    return out if meta.scanned else out[0]


# ---------------------------------------------------------------------------
# Logical <-> storage converters (checkpoints, elastic re-sharding, tests)
# ---------------------------------------------------------------------------

def logical_shape(meta: LeafMeta, ctx: ShardCtx) -> tuple:
    """Global logical tensor shape (the TP slicing undone)."""
    if meta.tp_replicated:
        return meta.local_shape
    s = list(meta.local_shape)
    s[meta.tp_dim] *= ctx.tp // meta.tp_repl
    return tuple(s)


def logical_to_storage(x, meta: LeafMeta, ctx: ShardCtx) -> torch.Tensor:
    """One logical layer tensor -> (tp, dp, shard_len) storage layout."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n = meta.numel()
    sl = shard_len(meta, ctx)
    if meta.tp_replicated:
        flat = x.reshape(1, n).expand(ctx.tp, n)
    else:
        shards = ctx.tp // meta.tp_repl
        if x.shape[meta.tp_dim] % shards:
            raise ValueError(f"dim {meta.tp_dim} of {tuple(x.shape)} does "
                             f"not split into {shards} TP shards")
        parts = torch.split(x, x.shape[meta.tp_dim] // shards,
                            dim=meta.tp_dim)
        flat = torch.stack([p.reshape(-1) for p in parts])
        if meta.tp_repl > 1:
            flat = flat.repeat_interleave(meta.tp_repl, dim=0)
    flat = torch.nn.functional.pad(flat, (0, ctx.dp * sl - n))
    return flat.reshape(ctx.tp, ctx.dp, sl)


def storage_to_logical(st, meta: LeafMeta, ctx: ShardCtx) -> torch.Tensor:
    """(tp, dp, shard_len) storage -> one logical layer tensor."""
    n = meta.numel()
    flat = torch.as_tensor(st).reshape(ctx.tp, -1)[:, :n]
    if meta.tp_replicated:
        return flat[0].reshape(meta.local_shape)
    shards = ctx.tp // meta.tp_repl
    if meta.tp_repl > 1:
        flat = flat.reshape(shards, meta.tp_repl, n)[:, 0]
    tp_dim = meta.tp_dim % len(meta.local_shape)
    x = flat.reshape((shards,) + tuple(meta.local_shape))
    x = torch.movedim(x, 0, tp_dim)
    shp = list(meta.local_shape)
    shp[tp_dim] *= shards
    return x.reshape(tuple(shp))


# ---------------------------------------------------------------------------
# The gather: storage -> usable weight (per layer)
# ---------------------------------------------------------------------------

def _repl_groups(repl: int, ctx: ShardCtx):
    """The TP index groups whose ranks hold one shard of a partially
    replicated leaf (``repl`` consecutive ranks each)."""
    return tuple(tuple(s * repl + j for j in range(repl))
                 for s in range(ctx.tp // repl))


def make_gathers(ctx: ShardCtx):
    """FSDP gather fns: (plain, full-tp-psum, groups-psum-factory).  The
    last two add the TP psum of a replicated leaf's gradient, ahead of the
    DP reduce-scatter in the backward."""
    g_plain = F.make_fsdp_gather(ctx.fsdp_config())

    def g_tp(bundle):
        return _TPPsumGrad.apply(g_plain(bundle), ctx, None)

    def g_groups(repl: int):
        groups = _repl_groups(repl, ctx)

        def g(bundle):
            return _TPPsumGrad.apply(g_plain(bundle), ctx, groups)
        return g

    return g_plain, g_tp, g_groups


def _tp_quantized_psum(g: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The TP psum of a replicated leaf's gradient through the quantized
    butterfly: the mean over the TP group by
    :func:`repro_torch.dist.collectives.butterfly_allreduce_mean` (packed
    lattice wire), scaled back by tp.

    The distance bound is twice the TP-max absolute gradient entry (a
    bound on |own - partner| for any pair), the same on every rank; the
    bucket shrinks (down to 32) until it is no longer than the leaf.  The
    dither key is the shared constant ``_TP_SYNC_SEED``, so every rank
    derives the same offsets and the output is common to the TP ranks."""
    gf = g.to(torch.float32).reshape(-1)
    n = gf.shape[0]
    b = ctx.qcfg.bucket
    while b > 32 and n < b:
        b //= 2
    qc = dataclasses.replace(ctx.qcfg, bucket=b)
    nb = flat_size_padded(n, qc) // b
    y = 2.0 * pmax_tp(torch.amax(torch.abs(gf)), ctx) + 1e-20
    y_b = torch.ones(nb, dtype=torch.float32, device=gf.device) * y
    mean, _aux = butterfly_allreduce_mean(
        gf, y_b, _random.PRNGKey(_TP_SYNC_SEED), qc, ctx.tp_axis)
    return (mean * ctx.tp).reshape(g.shape).to(g.dtype)


class _TPPsumGrad(torch.autograd.Function):
    """Identity forward; the backward psums the gradient over TP (over
    ``groups`` of TP indices when given), through the quantized butterfly
    when ``ctx.quantize_tp_grads`` and tp is a power of two."""

    @staticmethod
    def forward(fc, x, ctx: ShardCtx, groups):
        fc.sctx, fc.groups = ctx, groups
        return x.view_as(x)

    @staticmethod
    def backward(fc, g):
        ctx, groups = fc.sctx, fc.groups
        if (groups is None and ctx.quantize_tp_grads and ctx.tp > 1
                and (ctx.tp & (ctx.tp - 1)) == 0):
            return _tp_quantized_psum(g, ctx), None, None
        return _psum(g, ctx, groups), None, None


def _tp_wrap(w_full: torch.Tensor, meta: LeafMeta, ctx: ShardCtx):
    """A gathered leaf with the TP psum of its gradient attached, as the
    reference's gathers choose it."""
    if ctx.tp == 1:
        return w_full
    if meta.tp_replicated:
        return _TPPsumGrad.apply(w_full, ctx, None)
    if meta.tp_repl > 1:
        return _TPPsumGrad.apply(w_full, ctx, _repl_groups(meta.tp_repl, ctx))
    return w_full


def gather_param(storage: torch.Tensor, meta: LeafMeta, ctx: ShardCtx,
                 y, key, tele: torch.Tensor, gathers,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """A rank's storage slice (1, 1, shard) -> the full TP-local weight.

    y: this leaf's distance-bound state (() or (nb,) f32, or {"y", "anchor"}
    anchored); tele: (leaf_tele_width,) zeros requiring grad, whose gradient
    carries back the per-bucket decode telemetry."""
    g_plain, g_tp, g_groups = gathers
    bundle = {"w": storage.reshape(-1), "y": y, "key": key, "tele": tele}
    if meta.tp_replicated and ctx.tp > 1:
        fn = g_tp
    elif meta.tp_repl > 1 and ctx.tp > 1:
        fn = g_groups(meta.tp_repl)
    else:
        fn = g_plain
    w_full = fn(bundle)
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
    """Consume a prefetched handle -> the full TP-local weight.  The TP
    psum of the gradient attaches here, at the point of use, so the
    backward runs slice-transpose -> TP psum -> the DP reduce-scatter: the
    collective order of the monolithic :func:`gather_param`."""
    _, wait = split
    w_full = _tp_wrap(wait(handle), meta, ctx)
    n = meta.numel()
    return w_full[:n].reshape(meta.local_shape).to(compute_dtype)


# ---------------------------------------------------------------------------
# TP collectives.  Each differentiated one pins its adjoint to the
# same-group collective, as the reference's custom_vjps do: transpose(psum)
# = psum, transpose(all_gather) = reduce-scatter-sum and vice versa; the
# loss is divided by tp to compensate (models/transformer.make_loss_fn).
# ---------------------------------------------------------------------------

def _tp_gather_stack(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """Every TP rank's ``x`` stacked in rank order: (tp, *x.shape)."""
    return C._all_gather(x.contiguous(), ctx.tp_axis)


def _psum(x: torch.Tensor, ctx: ShardCtx, groups=None) -> torch.Tensor:
    """Sum of ``x`` over the TP ranks (over this rank's group of TP
    indices when ``groups`` is given), added in rank order."""
    if ctx.tp == 1:
        return x
    parts = _tp_gather_stack(x, ctx)
    members = range(ctx.tp)
    if groups is not None:
        me = tp_index(ctx)
        members = next(g for g in groups if me in g)
    out = None
    for m in members:
        out = parts[m] if out is None else out + parts[m]
    return out


def _all_gather_cat(x: torch.Tensor, ctx: ShardCtx, axis: int
                    ) -> torch.Tensor:
    """Tiled all-gather over TP: the ranks' ``x`` concatenated on ``axis``."""
    return torch.cat(list(_tp_gather_stack(x, ctx).unbind(0)), dim=axis)


def _reduce_scatter(x: torch.Tensor, ctx: ShardCtx, axis: int
                    ) -> torch.Tensor:
    """Tiled reduce-scatter-sum over TP along ``axis``: rank j gets the sum
    of every rank's j-th slice, the terms added in rank order.  Each rank
    sends slice j to rank j (gloo has no reduce-scatter)."""
    world, rank = ctx.tp, tp_index(ctx)
    parts = torch.chunk(x, world, dim=axis)
    got = [None] * world
    got[rank] = parts[rank]
    for k in range(1, world):
        perm = [(i, (i + k) % world) for i in range(world)]
        got[(rank - k) % world] = C._ppermute(
            parts[(rank + k) % world].contiguous(), perm, ctx.tp_axis)
    out = got[0]
    for p in got[1:]:
        out = out + p
    return out


def _all_to_all(x: torch.Tensor, ctx: ShardCtx, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all over TP (``jax.lax.all_to_all(..., tiled=True)``):
    ``x`` splits into tp slices along ``split_axis``, slice j goes to rank
    j, and the slices received are concatenated along ``concat_axis`` in
    the senders' rank order.  One ``ppermute`` round per rank offset, as
    :func:`_reduce_scatter`; it moves values only, so it is exact."""
    world, rank = ctx.tp, tp_index(ctx)
    parts = torch.chunk(x, world, dim=split_axis)
    got = [None] * world
    got[rank] = parts[rank]
    for k in range(1, world):
        perm = [(i, (i + k) % world) for i in range(world)]
        got[(rank - k) % world] = C._ppermute(
            parts[(rank + k) % world].contiguous(), perm, ctx.tp_axis)
    return torch.cat(got, dim=concat_axis)


class _PsumTP(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, ctx: ShardCtx):
        fc.sctx = ctx
        return _psum(x, ctx)

    @staticmethod
    def backward(fc, g):
        return _psum(g, fc.sctx), None


class _AllGatherTP(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, ctx: ShardCtx, axis: int):
        fc.sctx, fc.axis = ctx, axis
        return _all_gather_cat(x, ctx, axis)

    @staticmethod
    def backward(fc, g):
        return _reduce_scatter(g, fc.sctx, fc.axis), None, None


class _ReduceScatterTP(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, ctx: ShardCtx, axis: int):
        fc.sctx, fc.axis = ctx, axis
        return _reduce_scatter(x, ctx, axis)

    @staticmethod
    def backward(fc, g):
        return _all_gather_cat(g, fc.sctx, fc.axis), None, None


class _AllToAllTP(torch.autograd.Function):
    @staticmethod
    def forward(fc, x, ctx: ShardCtx, split_axis: int, concat_axis: int):
        fc.sctx, fc.axes = ctx, (split_axis, concat_axis)
        return _all_to_all(x, ctx, split_axis, concat_axis)

    @staticmethod
    def backward(fc, g):
        split_axis, concat_axis = fc.axes
        return _all_to_all(g, fc.sctx, concat_axis, split_axis), None, None, \
            None


def psum_tp(x, ctx: ShardCtx):
    return _PsumTP.apply(x, ctx) if ctx.tp > 1 else x


def pmax_tp(x, ctx: ShardCtx, groups=None):
    """Elementwise max over the TP ranks, or over this rank's group of TP
    indices when ``groups`` is given (no gradient, as the reference's
    callers stop it)."""
    if ctx.tp == 1:
        return x
    parts = _tp_gather_stack(x.detach(), ctx)
    if groups is not None:
        me = tp_index(ctx)
        parts = parts[list(next(g for g in groups if me in g))]
    return torch.amax(parts, dim=0)


def all_gather_group(x: torch.Tensor, ctx: ShardCtx, groups, axis: int
                     ) -> torch.Tensor:
    """Tiled all-gather over this rank's group of TP indices (``groups``
    partitions them; ``axis_index_groups``): the members' ``x``
    concatenated on ``axis`` in the group's order.  One ``ppermute`` round
    per offset within the groups, every group at once, so each rank
    receives only its group's slices (no gradient)."""
    me = tp_index(ctx)
    mine = next(g for g in groups if me in g)
    n, at = len(mine), mine.index(me)
    x = x.detach().contiguous()
    got = [None] * n
    got[at] = x
    for k in range(1, n):
        perm = [(g[a], g[(a + k) % len(g)]) for g in groups
                for a in range(len(g))]
        got[(at - k) % n] = C._ppermute(x, perm, ctx.tp_axis)
    return torch.cat(got, dim=axis)


def all_gather_tp(x, ctx: ShardCtx, axis: int = 0):
    return _AllGatherTP.apply(x, ctx, axis) if ctx.tp > 1 else x


def reduce_scatter_tp(x, ctx: ShardCtx, axis: int = 0):
    return _ReduceScatterTP.apply(x, ctx, axis) if ctx.tp > 1 else x


def all_to_all_tp(x, ctx: ShardCtx, split_axis: int, concat_axis: int):
    """Tiled all-to-all over TP; its backward is the reverse all-to-all
    (split and concat axes swapped), the transpose of a permutation."""
    if ctx.tp == 1:
        return x
    return _AllToAllTP.apply(x, ctx, split_axis, concat_axis)


def tp_index(ctx: ShardCtx) -> int:
    return dist.get_rank(ctx.tp_axis) if ctx.tp > 1 else 0
