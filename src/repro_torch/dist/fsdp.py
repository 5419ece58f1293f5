"""ZeRO-3 parameter gather with quantized gradient reduce-scatter;
counterpart of ``repro.dist.fsdp``.

Storage layout (``models/sharding.py``): every parameter leaf lives flat,
padded to ``dp * bucket`` granularity, and each DP rank holds one shard.
Inside a layer the gather rebuilds the full flat weight:

  forward:   w_full = all_gather(cast(w_shard, gather_dtype)) over the DP
             process groups, innermost first;
  backward:  g_shard = quantized reduce-scatter-mean of the ranks'
             cotangents (``sync="lq"``: recursive halving,
             :func:`repro_torch.dist.collectives.rh_reduce_scatter_mean`,
             the paper's lattice quantization, outermost group first with
             the kept segment's per-bucket bounds threaded on; anchored:
             the butterfly on ``g - anchor``), or the exact f32 mean
             (``sync="fp32"``).

Where the reference names mesh axes, the port takes a tuple of
``torch.distributed`` process groups, outermost first (``None`` is the
default group).  The gather is one ``torch.autograd.Function``; its
backward runs the sync and returns the telemetry row
``[max_dist, fails, y_next | dist_b | fails_b | anchor_next]`` (the
reference's ``_pack_tele``) as the gradient of the caller's zero ``tele``
input, so ``loss.backward()`` leaves each leaf's decode statistics in
``tele.grad``.  Every float step repeats the reference's operations in its
order, so the shard and the telemetry equal the reference's bit for bit
for the same cotangent (the f32 sync sums the ranks in rank order, see
:func:`_fp32_reduce_scatter`).

The split gather (``FSDPConfig.prefetch``): :func:`make_fsdp_gather_split`
returns ``gather_async``, which issues the all-gather at once (``async_op``)
and returns a :class:`GatherHandle`, and :func:`gather_wait`, which waits
for it at the point of use and builds the same autograd node as the
monolithic gather — so split and monolithic give the same bits, values and
gradients.

bf16 crosses every group as its bytes (a uint8 view: exact, and a type
every backend moves).  With gloo, CUDA tensors are staged through pinned host memory,
as :mod:`repro_torch.dist.collectives` does: several ranks share one card
there, and NCCL refuses that.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch import random as _random
from repro_torch.core import wire_accounting as WA
from repro_torch.core.qstate import QState
from repro_torch.dist import collectives as C
from repro_torch.dist.collectives import (QSyncConfig, butterfly_allreduce_mean,
                                          rh_reduce_scatter_mean,
                                          wire_bytes_butterfly, wire_bytes_rh)

# tele scalar rows: [max observed distance, decode failures, suggested next y]
TELE_WIDTH = 3


@dataclasses.dataclass(frozen=True)
class FSDPConfig:
    """Static config of the FSDP gather (derived from ShardCtx).

    axes: the DP process groups, outermost first (``None``: the default
    group).  Prefetching is the model loop's choice (``ShardCtx.prefetch``)
    and needs no field here."""
    axes: tuple = (None,)
    qcfg: QSyncConfig = QSyncConfig()
    sync: str = "lq"                    # "lq" | "fp32"
    gather_dtype: str = "bfloat16"
    anchored: bool = False              # butterfly sync anchored on the
                                        # previous step's decoded mean
    anchor_sharded: bool = True         # anchored: store (shard,) anchors and
                                        # rebuild via a fwd all-gather (f32)

    def __post_init__(self):
        if self.sync not in ("lq", "fp32"):
            raise ValueError(f"sync must be 'lq' or 'fp32', got {self.sync!r}")


def pad_to_shardable(n: int, dp: int, bucket: int) -> int:
    """Smallest multiple of dp*bucket >= n (flat storage size of a leaf)."""
    g = max(dp * bucket, 1)
    return -(-max(n, 1) // g) * g


def _size(group) -> int:
    """Ranks in ``group``; 1 when no process group was started (a dp = 1
    forward needs none)."""
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _index(group) -> int:
    if group is None and not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _dp_sizes(axes) -> "list[int]":
    return [_size(g) for g in axes]


def _rank_linear(axes) -> int:
    """Linear DP rank in (outer, ..., inner)-major order (the storage
    layout's shard index)."""
    idx = 0
    for g in axes:
        idx = idx * _size(g) + _index(g)
    return idx


def _effective_bucket(cfg: QSyncConfig, m: int, dp: int) -> int:
    """Largest power-of-two bucket <= cfg.bucket that tiles m over dp ranks
    (mirrors models/sharding.effective_bucket's padding)."""
    b = cfg.bucket
    while b > 1 and m % (dp * b):
        b //= 2
    return b


def leaf_nb(m: int, dp: int, qcfg: QSyncConfig) -> int:
    """Bucket count of a gathered leaf's DP gradient sync (static)."""
    return m // _effective_bucket(qcfg, m, dp)


def tele_width(nb: int, m: int = 0, anchored: bool = False) -> int:
    """Tele-leaf length carrying per-bucket maps (+ the anchor if asked):
    [3 scalars | dist_b (nb) | fails_b (nb) | anchor_next (m, anchored)]."""
    return TELE_WIDTH + 2 * nb + (m if anchored else 0)


def wire_bytes_bwd(m: int, sizes: "list[int]", cfg: FSDPConfig) -> int:
    """Bytes *sent per rank* by one gradient sync of a gathered leaf of
    length m over DP groups of ``sizes`` (outermost first): the packed
    recursive-halving payloads (lq), the butterfly's full payloads per
    group (anchored), or the ring reduce-scatter's f32 (fp32)."""
    dp = math.prod(sizes)
    total, cur = 0, m
    if cfg.sync == "fp32":
        for ws in sizes:
            total += WA.fp32_ring_reduce_scatter_bytes(cur, ws)
            cur //= ws
        return total
    b = _effective_bucket(cfg.qcfg, m, dp)
    qc = dataclasses.replace(cfg.qcfg, bucket=b)
    if cfg.anchored:
        return sum(wire_bytes_butterfly(m, ws, qc) for ws in sizes)
    for ws in sizes:
        total += wire_bytes_rh(cur, ws, qc)
        cur //= ws
    return total


def anchor_bytes_step(m: int, sizes: "list[int]", cfg: FSDPConfig) -> int:
    """Per-rank anchor-state bytes one step materializes beyond the rank's
    own shard: 0 unless anchored, 0 with a sharded anchor."""
    if not (cfg.anchored and cfg.sync == "lq"):
        return 0
    return WA.anchor_state_bytes(m, math.prod(sizes), cfg.anchor_sharded)


def anchor_gather_bytes_fwd(m: int, sizes: "list[int]", cfg: FSDPConfig) -> int:
    """Per-rank forward wire bytes of rebuilding a sharded anchor."""
    if not (cfg.anchored and cfg.sync == "lq" and cfg.anchor_sharded):
        return 0
    return WA.anchor_gather_bytes(m, math.prod(sizes))


def _split_y(y_entry):
    """bundle['y'] -> (y scalar-or-(nb,), anchor-or-None)."""
    if isinstance(y_entry, dict):
        return y_entry["y"], y_entry.get("anchor")
    return y_entry, None


def _y_per_bucket(y, nb: int, device) -> torch.Tensor:
    """Promote a scalar distance bound to the per-bucket vector."""
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    if y.dim() == 0:
        return torch.ones(nb, dtype=torch.float32, device=device) * y
    y = y.reshape(-1)
    if y.shape[0] != nb:
        raise ValueError(f"per-bucket y has {y.shape[0]} entries, leaf has "
                         f"{nb} buckets")
    return y


def _pack_tele(tele_like: torch.Tensor, max_dist, fails, y_next, dist_b,
               fails_b, anchor_next=None) -> torch.Tensor:
    """Fill the tele gradient up to whatever width the caller allotted."""
    parts = [torch.stack([max_dist, fails, y_next])]
    width = tele_like.shape[0]
    if dist_b is not None and width >= TELE_WIDTH + 2 * dist_b.shape[0]:
        parts += [dist_b, fails_b]
    if anchor_next is not None and width >= sum(p.shape[0] for p in parts) \
            + anchor_next.shape[0]:
        parts.append(anchor_next)
    flat = torch.cat(parts).to(torch.float32)
    out = torch.zeros_like(tele_like)
    out[: flat.shape[0]] = flat
    return out


# ---------------------------------------------------------------------------
# Tiled all-gather over a group (the forward's and the telemetry maps')
# ---------------------------------------------------------------------------

class _Pending:
    """One issued tiled all-gather of a flat tensor over ``groups``
    (innermost first): the innermost group's gather runs asynchronously,
    the outer ones run in :meth:`wait`."""

    def __init__(self, t: torch.Tensor, groups):
        self.dtype, self.device = t.dtype, t.device
        self.groups = list(groups)
        self._work = None
        self._out = self._issue(t.reshape(-1))

    def _issue(self, t: torch.Tensor):
        if not self.groups:
            return t
        group = self.groups[0]
        world = _size(group)
        if world == 1:
            self.groups.pop(0)
            return self._issue(t)
        src = t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
        staged = C._host_staged(src, group)
        src = C._to_host(src) if staged else src.contiguous()
        out = torch.empty((world,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device, pin_memory=staged)
        if dist.get_backend(group) == dist.Backend.GLOO:
            self._work = dist.all_gather(list(out.unbind(0)), src,
                                         group=group, async_op=True)
        else:
            self._work = dist.all_gather_into_tensor(
                out.view(-1), src.view(-1), group=group, async_op=True)
        return out

    def wait(self) -> torch.Tensor:
        out = self._out
        while self._work is not None:
            self._work.wait()
            self._work = None
            self.groups.pop(0)
            out = out.reshape(-1).to(self.device)
            if out.dtype != self.dtype:
                out = out.view(self.dtype)
            out = self._issue(out)
        return out.reshape(-1)


def _gather_tiled(t: torch.Tensor, groups) -> torch.Tensor:
    """Tiled all-gather of flat ``t`` over ``groups`` (innermost first)."""
    return _Pending(t, groups).wait()


# ---------------------------------------------------------------------------
# The gather's two halves
# ---------------------------------------------------------------------------

def _gather_dtype(cfg: FSDPConfig) -> torch.dtype:
    return getattr(torch, cfg.gather_dtype)


def _issue(cfg: FSDPConfig, w: torch.Tensor, anchor) -> "tuple":
    """Issue the forward's all-gathers: the weight in ``gather_dtype`` and,
    for a sharded anchor, the f32 anchor in the same slot."""
    inner_first = list(reversed(cfg.axes))
    with torch.no_grad():
        pw = _Pending(w.detach().reshape(-1).to(_gather_dtype(cfg)),
                      inner_first)
        pa = None
        if cfg.anchored and anchor is not None:
            a = anchor.detach().reshape(-1).to(torch.float32)
            pa = _Pending(a, inner_first if a.shape[0] == w.numel() else [])
    return pw, pa


def _gather_value(cfg: FSDPConfig, pending) -> "tuple":
    """Wait for the issued gathers: (w_full, anchor_full or None)."""
    pw, pa = pending
    return pw.wait(), (None if pa is None else pa.wait())


def _fp32_reduce_scatter(g: torch.Tensor, group) -> torch.Tensor:
    """Exact reduce-scatter-sum of flat ``g`` over ``group``: every rank
    sends segment j to rank j (gloo has no reduce-scatter) and sums the
    segments it receives in rank order."""
    world, rank = _size(group), _index(group)
    seg = g.shape[0] // world
    parts = g.reshape(world, seg)
    got = [None] * world
    got[rank] = parts[rank]
    for k in range(1, world):
        perm = [(i, (i + k) % world) for i in range(world)]
        got[(rank - k) % world] = C._ppermute(
            parts[(rank + k) % world].contiguous(), perm, group)
    out = got[0]
    for p in got[1:]:
        out = out + p
    return out


def _bwd_rh(cfg: FSDPConfig, g: torch.Tensor, y_val, anchor, key):
    """Quantized reduce-scatter chain (rh per group; butterfly when
    anchored).  Returns (g_shard, tele fields)."""
    sizes = _dp_sizes(cfg.axes)
    dp = math.prod(sizes)
    m = g.shape[0]
    b = _effective_bucket(cfg.qcfg, m, dp)
    qc = dataclasses.replace(cfg.qcfg, bucket=b)
    nb = m // b
    dev = g.device
    y_b = _y_per_bucket(y_val, nb, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fails, max_dist, y_next = zero, zero, zero

    if cfg.anchored and anchor is not None:
        cur = g
        fails_b = torch.zeros(nb, dtype=torch.float32, device=dev)
        dist_b = torch.zeros(nb, dtype=torch.float32, device=dev)
        for i, group in enumerate(cfg.axes):
            cur, aux = butterfly_allreduce_mean(
                cur, QState(y=y_b, anchor=anchor), _random.fold_in(key, i),
                qc, group)
            fails = fails + aux.fails
            max_dist = torch.maximum(max_dist, aux.max_dist)
            y_next = torch.maximum(y_next, aux.y_next)
            fails_b = fails_b + aux.fails_b
            dist_b = torch.maximum(dist_b, aux.dist_b)
        shard = m // dp
        r = _rank_linear(cfg.axes)
        g_shard = cur[r * shard:(r + 1) * shard]
        return g_shard, (max_dist, fails, y_next, dist_b, fails_b, cur)

    g_shard = g
    y_cur = y_b
    fails_seg = dist_seg = None
    for i, group in enumerate(cfg.axes):       # outermost first
        g_shard, aux = rh_reduce_scatter_mean(
            g_shard, y_cur, _random.fold_in(key, i), qc, group)
        fails = fails + aux.fails
        max_dist = torch.maximum(max_dist, aux.max_dist)
        y_next = torch.maximum(y_next, aux.y_next)
        y_cur = aux.y_seg
        nb_new = aux.fails_b.shape[0]
        if fails_seg is None:
            fails_seg, dist_seg = aux.fails_b, aux.dist_b
        else:
            off = _index(group) * nb_new
            fails_seg = fails_seg[off:off + nb_new] + aux.fails_b
            dist_seg = torch.maximum(dist_seg[off:off + nb_new], aux.dist_b)
    if fails_seg is not None and dp > 1:
        # every rank's final segment of the per-bucket maps, so all ranks
        # report (and update y from) identical full-leaf maps
        inner_first = list(reversed(cfg.axes))
        fails_b = _gather_tiled(fails_seg, inner_first)
        dist_b = _gather_tiled(dist_seg, inner_first)
    elif fails_seg is not None:
        fails_b, dist_b = fails_seg, dist_seg
    else:
        fails_b = torch.zeros(nb, dtype=torch.float32, device=dev)
        dist_b = torch.zeros(nb, dtype=torch.float32, device=dev)
    return g_shard, (max_dist, fails, y_next, dist_b, fails_b, None)


def _sync_grad(cfg: FSDPConfig, g: torch.Tensor, y_entry, key,
               tele_like: torch.Tensor, anchor_full):
    """The gather's backward: the cotangent's DP sync.  Returns
    (g_shard f32, tele row)."""
    y_val, anchor_stored = _split_y(y_entry)
    g = g.reshape(-1).to(torch.float32)
    dp = math.prod(_dp_sizes(cfg.axes))
    if cfg.sync == "fp32":
        gs = g
        for group in cfg.axes:                   # outermost first
            gs = _fp32_reduce_scatter(gs, group)
        return gs / dp, torch.zeros_like(tele_like)
    g_shard, (max_dist, fails, y_next, dist_b, fails_b,
              anchor_next) = _bwd_rh(cfg, g, y_val, anchor_full, key)
    if anchor_next is not None and anchor_stored is not None:
        stored_len = anchor_stored.numel()
        if stored_len < anchor_next.shape[0]:
            # sharded anchor: the tele carries back only this rank's slice
            r = _rank_linear(cfg.axes)
            anchor_next = anchor_next[r * stored_len:(r + 1) * stored_len]
    return g_shard, _pack_tele(tele_like, max_dist, fails, y_next, dist_b,
                               fails_b, anchor_next)


class _FSDPGather(torch.autograd.Function):
    """w_shard -> w_full (forward: gather; backward: the DP sync, with the
    telemetry row as the gradient of ``tele``)."""

    @staticmethod
    def forward(ctx, w, tele, cfg, y_entry, key, pending):
        if pending is None:
            pending = _issue(cfg, w, _split_y(y_entry)[1])
        w_full, anchor_full = _gather_value(cfg, pending)
        if anchor_full is not None and anchor_full.shape[0] != w_full.shape[0]:
            raise ValueError(
                f"anchor length {anchor_full.shape[0]} matches neither the "
                f"shard ({w.numel()}) nor the gathered leaf "
                f"({w_full.shape[0]})")
        ctx.cfg, ctx.y_entry, ctx.key = cfg, y_entry, key
        ctx.w_dtype = w.dtype
        ctx.tele_shape = (tele.shape, tele.dtype, tele.device)
        ctx.save_for_backward(anchor_full)
        return w_full

    @staticmethod
    def backward(ctx, g):
        (anchor_full,) = ctx.saved_tensors
        shape, dtype, device = ctx.tele_shape
        g_shard, tele = _sync_grad(ctx.cfg, g, ctx.y_entry, ctx.key,
                                   torch.zeros(shape, dtype=dtype,
                                               device=device), anchor_full)
        return g_shard.to(ctx.w_dtype), tele, None, None, None, None


def make_fsdp_gather(cfg: FSDPConfig):
    """Returns gather(bundle) -> w_full.

    bundle: {"w": (shard,) storage shard (requires grad),
             "y": () f32 | (nb,) per-bucket bounds
                  | {"y": (nb,), "anchor": (m,) or (shard,)} (anchored),
             "key": a ``repro_torch.random`` key,
             "tele": (>= TELE_WIDTH,) zeros (requires grad)}.
    w_full: (dp * shard,) in cfg.gather_dtype."""
    def gather(bundle):
        return _FSDPGather.apply(bundle["w"], bundle["tele"], cfg,
                                 bundle["y"], bundle["key"], None)
    return gather


@dataclasses.dataclass
class GatherHandle:
    """An issued split gather: the bundle and its in-flight all-gathers."""
    cfg: FSDPConfig
    bundle: dict
    pending: tuple


def gather_wait(handle: GatherHandle) -> torch.Tensor:
    """Consume a prefetched gather (the *wait* half): waits for the issued
    all-gather and returns w_full, with the same backward as the monolithic
    gather."""
    b = handle.bundle
    return _FSDPGather.apply(b["w"], b["tele"], handle.cfg, b["y"], b["key"],
                             handle.pending)


def make_fsdp_gather_split(cfg: FSDPConfig):
    """``(gather_async, gather_wait)``: ``gather_async(bundle)`` issues the
    all-gather (and a sharded anchor's) now and returns a
    :class:`GatherHandle`; :func:`gather_wait` consumes it at the point of
    use.  Split and monolithic give the same bits."""
    def gather_async(bundle) -> GatherHandle:
        return GatherHandle(cfg, bundle, _issue(
            cfg, bundle["w"], _split_y(bundle["y"])[1]))
    return gather_async, gather_wait
