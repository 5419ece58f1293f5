"""Fault-tolerant ZeRO-3 trainer; counterpart of ``repro.train.trainer``.

One step, on every rank (one process each, a (DP, TP) mesh of them):
  1. the local loss, then ``loss.backward()``: each layer's FSDP gather
     (``dist/fsdp.py``) reduce-scatters its gradient over DP with the
     paper's lattice quantization (a replicated leaf's after its TP psum,
     ``models/sharding.py``), and the per-bucket decode telemetry
     arrives as the gradient of the zero ``tele`` inputs;
  2. the global grad-norm: each leaf's local sum of squares, summed over
     the DP ranks in rank order (one small all-gather for all leaves) and,
     for a leaf sliced over TP, over the TP ranks too; added in the
     reference's leaf order; then the shard-local optimizer;
  3. the per-bucket ``y`` state from the telemetry (the transition of
     :func:`repro_torch.core.qstate.update_y`): failed buckets escalate,
     clean ones relax toward their measured distances.

The autograd engine runs the backward's nodes in an order fixed by the
graph (one device, one thread), and every rank builds the same graph, so
every rank issues its leaves' syncs, and its TP collectives, in the same
order.  The batch rows are drawn per DP rank; the TP ranks of a DP group
share them.

Fault tolerance as the reference's: checkpoint every ``ckpt_every`` steps
(atomic, logical layout); the loop catches a ``RuntimeError`` (a CUDA,
kernel or collective error is one), restores the last checkpoint and
replays; data is stateless-seeded, so the replay is deterministic.  After
``max_restarts`` restarts the error propagates.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as _random
from repro_torch import resolve_device
from repro_torch.core.lattice import fma_f32
from repro_torch.dist import fsdp as F
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx, _psum, shard_len, tp_index
from repro_torch.train import checkpoint as C
from repro_torch.train import data as D
from repro_torch.train import optim as O


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatch: int = 0            # 0 = no accumulation
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None  # None: a fresh one under TMPDIR
    log_every: int = 10
    keep: int = 3
    max_restarts: int = 3
    y0: float = 1.0                # per-coordinate distance guess
    y_decay: float = 0.99          # relax y toward measured distance
    y_escalate: float = 2.0        # on detected decode failure


def _relax(y: torch.Tensor, candidate: torch.Tensor, decay: float
           ) -> torch.Tensor:
    """``decay * y + (1 - decay) * candidate`` with the first product and
    the sum rounded once, as the reference's compiled step contracts it."""
    return fma_f32(torch.tensor(decay, dtype=torch.float32,
                                device=y.device).expand_as(y), y,
                   (1 - decay) * candidate)


def _update_y(y, fails_b, dist_b, tc: TrainConfig, margin: float = 2.5,
              floor: float = 1e-8) -> torch.Tensor:
    """:func:`repro_torch.core.qstate.update_y` as the train step runs it
    (its relaxation contracted, see :func:`_relax`)."""
    clipped = torch.minimum(torch.maximum(margin * dist_b, 0.25 * y), 4.0 * y)
    candidate = torch.where(dist_b > floor, clipped, y)
    relaxed = _relax(y, candidate, tc.y_decay)
    return torch.clamp_min(torch.where(fails_b > 0, y * tc.y_escalate,
                                       relaxed), floor)


def _y_update(y, tele: torch.Tensor, tc: TrainConfig):
    """Per-leaf distance-bound state transition from the tele gradient.

    y: scalar state ((), (L,)), per-bucket state ((nb,), (L, nb)), or an
    anchored dict {"y": (..., nb), "anchor": ...}.  tele: (..., width).
    Bitwise with the reference's compiled step."""
    if isinstance(y, dict):
        nb = y["y"].shape[-1]
        m = y["anchor"].shape[-1]
        lo = F.TELE_WIDTH + 2 * nb
        return {"y": _y_update(y["y"], tele, tc),
                "anchor": tele[..., lo:lo + m].reshape(y["anchor"].shape)}
    if y.dim() == tele.dim() and \
            tele.shape[-1] >= F.TELE_WIDTH + 2 * y.shape[-1]:
        nb = y.shape[-1]
        dist_b = tele[..., F.TELE_WIDTH:F.TELE_WIDTH + nb]
        fails_b = tele[..., F.TELE_WIDTH + nb:F.TELE_WIDTH + 2 * nb]
        return _update_y(y, fails_b, dist_b, tc)
    # scalar leaf: one bound per leaf from the scalar telemetry
    max_dist, fails, y_next = tele[..., 0], tele[..., 1], tele[..., 2]
    candidate = torch.where(y_next > 1e-11,
                            torch.minimum(torch.maximum(y_next, 0.25 * y),
                                          4.0 * y), y)
    return torch.where(fails > 0, y * tc.y_escalate,
                       _relax(y, candidate, tc.y_decay))


def psum_dp(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """Sum of ``x`` over the DP groups (outermost first), each group's
    ranks added in rank order, so every rank holds the same bits."""
    for group in ctx.dp_axes:
        world = F._size(group)
        if world == 1:
            continue
        parts = F._gather_tiled(x.reshape(-1), [group]).reshape(world, -1)
        s = parts[0]
        for p in parts[1:]:
            s = s + p
        x = s.reshape(x.shape)
    return x


def _leaves(tree: dict, L: int) -> dict:
    """Fresh leaves requiring grad: stacked leaves as a list of per-layer
    slices (each its own leaf), top leaves as they are."""
    out = {"layers": {}, "top": {}}
    for k, v in tree["layers"].items():
        out["layers"][k] = [v[i].detach().requires_grad_(True)
                            for i in range(L)]
    for k, v in tree["top"].items():
        out["top"][k] = v.detach().requires_grad_(True)
    return out


def _grads(leaves: dict) -> dict:
    return {"layers": {k: torch.stack([t.grad for t in ls])
                       for k, ls in leaves["layers"].items()},
            "top": {k: t.grad for k, t in leaves["top"].items()}}


def make_train_step(cfg: ModelConfig, ctx: ShardCtx, opt_cfg: O.OptConfig,
                    tc: TrainConfig, device=None):
    """Returns step(state, batch) -> (state, metrics): ``batch`` holds this
    rank's rows; ``metrics`` {"loss" (DP mean), "gnorm", "fails"} are 0-d
    tensors with the same bits on every rank."""
    device = resolve_device(device)
    metas = T.all_metas(cfg, ctx)
    loss_fn = T.make_loss_fn(cfg, ctx)
    L = T.n_scan_steps(cfg)
    if ctx.anchor_grads and tc.microbatch > 1:
        raise ValueError("anchor_grads is incompatible with microbatch > 1")
    names = [(grp, k) for grp in ("layers", "top")
             for k in sorted(metas[grp])]

    def lg(params, y, batch_mb, kstep):
        p_in = _leaves(params, L)
        t_in = _leaves(T.tele_zeros(cfg, ctx, device=device), L)
        loss, metrics = loss_fn(p_in, t_in, batch_mb, kstep, y)
        loss.backward()
        return metrics, _grads(p_in), _grads(t_in)

    def step_fn(state, batch):
        params, opt, y, step, key = (state["params"], state["opt"],
                                     state["y"], state["step"], state["key"])
        kstep = _random.fold_in(key, step)
        if tc.microbatch > 1:
            mb = tc.microbatch
            b = next(iter(batch.values())).shape[0] // mb
            gp = gt = metrics = None
            for j in range(mb):
                part = {k: v[j * b:(j + 1) * b] for k, v in batch.items()}
                m_j, gp_j, gt_j = lg(params, y, part, kstep)
                if gp is None:
                    gp, gt, metrics = gp_j, gt_j, m_j
                    continue
                for grp in ("layers", "top"):
                    for k in gp[grp]:
                        gp[grp][k] = gp[grp][k] + gp_j[grp][k]
                        gt[grp][k] = torch.maximum(gt[grp][k], gt_j[grp][k])
                metrics = {k: metrics[k] + m_j[k] for k in metrics}
            gp = {grp: {k: v / mb for k, v in g.items()}
                  for grp, g in gp.items()}
            metrics = {k: v / mb for k, v in metrics.items()}
        else:
            metrics, gp, gt = lg(params, y, batch, kstep)

        # global grad norm: each leaf's sum of squares summed over DP (and
        # over TP for a leaf sliced over it), added in the reference's
        # leaf order
        sums = psum_dp(torch.stack([torch.sum(gp[g][k].to(torch.float32) ** 2)
                                    for g, k in names]), ctx)
        if ctx.tp > 1:
            sliced = torch.tensor([not metas[g][k].tp_replicated
                                   for g, k in names], device=sums.device)
            sums = torch.where(sliced, _psum(sums, ctx), sums)
        sq = torch.zeros((), dtype=torch.float32, device=sums.device)
        for s in sums:
            sq = sq + s
        gnorm = torch.sqrt(sq)

        params2, opt2 = O.apply_update(params, gp, opt, step, opt_cfg, gnorm)
        y2 = {grp: {k: _y_update(y[grp][k], gt[grp][k], tc) for k in y[grp]}
              for grp in ("layers", "top")}
        fails = torch.zeros((), dtype=torch.float32, device=device)
        for g, k in names:
            fails = fails + torch.sum(gt[g][k][..., 1])
        loss_rep = psum_dp(metrics["loss"].reshape(1), ctx)[0] / ctx.dp
        new_state = {"params": params2, "opt": opt2, "y": y2,
                     "step": step + 1, "key": key}
        return new_state, {"loss": loss_rep, "gnorm": gnorm, "fails": fails}

    return step_fn


def init_state(cfg: ModelConfig, ctx: ShardCtx, opt_cfg: O.OptConfig,
               tc: TrainConfig, key, *, dp_rank: Optional[int] = None,
               tp_rank: Optional[int] = None, device=None) -> dict:
    """The reference's initial state, as the slices of the rank at DP index
    ``dp_rank`` and TP index ``tp_rank`` (the process's own unless
    given)."""
    if dp_rank is None:
        dp_rank = F._rank_linear(ctx.dp_axes)
    if tp_rank is None:
        tp_rank = tp_index(ctx)
    params = T.init_params(cfg, ctx, key, dp_rank=dp_rank, tp_rank=tp_rank,
                           device=device)
    return {"params": params, "opt": O.init_opt_state(params, opt_cfg),
            "y": T.y_init(cfg, ctx, tc.y0, device=device), "step": 0,
            "key": key}


def _gather_shards(t: torch.Tensor, ctx: ShardCtx) -> Optional[np.ndarray]:
    """Every rank's ``(L?, 1, 1, shard)`` slice, stacked on the TP and DP
    axes into the reference's global ``(L?, tp, dp, shard)`` layout, on
    rank 0 (None elsewhere).  The default group's rank of a slice is
    dp_idx * tp + tp_idx (``launch/mesh.mesh_axes``' layout)."""
    world = ctx.tp * ctx.dp
    if world == 1:
        return t.detach().cpu().numpy()
    gloo = dist.get_backend() == dist.Backend.GLOO
    src = t.detach().cpu() if gloo else t.detach().contiguous()
    rank = dist.get_rank()
    parts = [torch.empty_like(src) for _ in range(world)] if rank == 0 \
        else None
    dist.gather(src, parts, dst=0)
    if rank != 0:
        return None
    flat = torch.stack([p.cpu()[..., 0, 0, :] for p in parts], dim=-2)
    lead = tuple(flat.shape[:-2])
    glob = flat.reshape(lead + (ctx.dp, ctx.tp, flat.shape[-1]))
    return glob.transpose(-3, -2).contiguous().numpy()


class Trainer:
    """Host-side loop with checkpoint/restart fault tolerance, one per DP
    rank.  ``extra_batch(step)`` adds this rank's rows of extra inputs (the
    VLM's patch embeddings)."""

    def __init__(self, cfg: ModelConfig, ctx: ShardCtx,
                 opt_cfg: O.OptConfig, tc: TrainConfig,
                 data_cfg: D.DataConfig,
                 extra_batch: Optional[Callable[[int], dict]] = None,
                 failure_hook: Optional[Callable[[int], None]] = None, *,
                 device=None):
        self.cfg, self.ctx = cfg, ctx
        self.extra_batch = extra_batch
        self.failure_hook = failure_hook
        self.device = resolve_device(device)
        self.rank = F._rank_linear(ctx.dp_axes)      # the DP rank: its rows
        self.tp_rank = tp_index(ctx)
        self.lead = not dist.is_initialized() or dist.get_rank() == 0
        if tc.ckpt_dir is None:
            tc = dataclasses.replace(
                tc, ckpt_dir=_fresh_ckpt_dir(self.lead, ctx.world))
        self.opt_cfg, self.tc, self.data_cfg = opt_cfg, tc, data_cfg
        if F._dp_sizes(ctx.dp_axes) and np.prod(F._dp_sizes(ctx.dp_axes)) \
                != ctx.dp:
            raise ValueError(f"ctx.dp={ctx.dp} but the DP groups hold "
                             f"{F._dp_sizes(ctx.dp_axes)} ranks")
        self.step_fn = make_train_step(cfg, ctx, opt_cfg, tc, self.device)
        self.metas = T.all_metas(cfg, ctx)
        self.history: list = []
        self.restarts = 0
        self.wire_bytes_step = self._wire_bytes_step()
        if self.lead:
            print(f"[train] grad sync wire: "
                  f"{self.wire_bytes_step / 2**20:.2f} MiB/step per rank "
                  f"({ctx.fsdp_config().sync}, packed={ctx.qcfg.packed})",
                  flush=True)
            cur_a = self._anchor_bytes_step(ctx.anchor_sharded)
            repl_a = self._anchor_bytes_step(False)
            print(f"[train] anchor state: {cur_a / 2**20:.2f} MiB/step per "
                  f"rank (anchored={ctx.anchor_grads}, "
                  f"sharded={ctx.anchor_sharded}; replicated equivalent "
                  f"{repl_a / 2**20:.2f} MiB) "
                  f"prefetch={'on' if ctx.prefetch else 'off'}", flush=True)

    def _per_group(self, fn) -> int:
        sizes = F._dp_sizes(self.ctx.dp_axes)
        per = {grp: sum(fn(shard_len(m, self.ctx) * self.ctx.dp, sizes)
                        for m in self.metas[grp].values())
               for grp in ("layers", "top")}
        return T.n_scan_steps(self.cfg) * per["layers"] + per["top"]

    def _wire_bytes_step(self) -> int:
        """Per-rank wire bytes of one step's DP gradient sync
        (fsdp.wire_bytes_bwd over every leaf)."""
        fcfg = self.ctx.fsdp_config()
        return max(self.tc.microbatch, 1) * self._per_group(
            lambda m, sizes: F.wire_bytes_bwd(m, sizes, fcfg))

    def _anchor_bytes_step(self, sharded: bool) -> int:
        """Per-rank anchor-state bytes one step materializes beyond each
        rank's own shard."""
        if not self.ctx.anchor_grads:
            return 0
        fcfg = dataclasses.replace(self.ctx.fsdp_config(),
                                   anchor_sharded=sharded)
        return self._per_group(
            lambda m, sizes: F.anchor_bytes_step(m, sizes, fcfg))

    def _batch(self, step: int) -> dict:
        b = D.local_batch_at(self.data_cfg, step, self.rank, self.ctx.dp,
                             device=self.device)
        if self.extra_batch is not None:
            b.update(self.extra_batch(step))
        return b

    def _init(self) -> dict:
        return init_state(self.cfg, self.ctx, self.opt_cfg, self.tc,
                          _random.PRNGKey(0), dp_rank=self.rank,
                          tp_rank=self.tp_rank, device=self.device)

    def save(self, state):
        """Rank 0 writes the logical tensors it gathers from every rank's
        shards (the reference's format), and its own ``y``."""
        trees = {"params": state["params"], **{f"opt/{k}": v for k, v in
                                               state["opt"].items()}}
        glob = {}
        for name, tree in trees.items():
            glob[name] = {grp: {k: _gather_shards(v, self.ctx)
                                for k, v in sorted(tree[grp].items())}
                          for grp in ("layers", "top")}
        y_np = {grp: {} for grp in ("layers", "top")}
        for grp in ("layers", "top"):
            for k, v in sorted(state["y"][grp].items()):
                if isinstance(v, dict):
                    a = v["anchor"]
                    y_np[grp][k] = {"y": v["y"].cpu().numpy(),
                                    "anchor": (_gather_shards(a, self.ctx)
                                               if self.ctx.anchor_sharded
                                               else a.cpu().numpy())}
                else:
                    y_np[grp][k] = v.cpu().numpy()
        if self.lead:
            logical = C.params_to_logical(glob["params"], self.metas, self.ctx)
            opt_logical = {k.split("/")[1]: C.params_to_logical(
                v, self.metas, self.ctx) for k, v in glob.items()
                if k.startswith("opt/")}
            C.save(self.tc.ckpt_dir, int(state["step"]),
                   {"params": logical, "opt": opt_logical, "y": y_np},
                   {"arch": self.cfg.arch}, keep=self.tc.keep)
        if self.ctx.world > 1:
            dist.barrier()

    def restore(self) -> Optional[dict]:
        """Every rank reads the latest checkpoint and keeps its own slices.
        A ``y`` whose shapes do not fit this layout keeps the fresh init
        (it re-converges within a few steps), as the reference does."""
        step = C.latest_step(self.tc.ckpt_dir)
        if step is None:
            return None
        tree, _ = C.load(self.tc.ckpt_dir, step)
        state = self._init()
        state["params"] = C.logical_to_params(tree["params"], self.metas,
                                              self.ctx, self.rank,
                                              self.device, self.tp_rank)
        if "opt" in tree:
            state["opt"] = {k: C.logical_to_params(v, self.metas, self.ctx,
                                                   self.rank, self.device,
                                                   self.tp_rank)
                            for k, v in tree["opt"].items()}
        fresh = T.y_init(self.cfg, self.ctx, self.tc.y0, device=self.device)
        restored = C.reshard_y(tree["y"], _global_y_shapes(fresh, self.ctx))
        y = _local_y(restored, fresh, self.ctx, self.rank, self.tp_rank,
                     self.device)
        if y is not None:
            state["y"] = y
        state["step"] = int(step)
        return state

    def train(self, state: Optional[dict] = None) -> dict:
        if state is None:
            state = self.restore() or self._init()
        restarts = 0
        while int(state["step"]) < self.tc.steps:
            step = int(state["step"])
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                batch = self._batch(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                if step % self.tc.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["dt"] = time.perf_counter() - t0
                    m["wire_mb"] = self.wire_bytes_step / 2**20
                    self.history.append(m)
                    if self.lead:
                        print(f"[train] step={step} loss={m['loss']:.4f} "
                              f"gnorm={m['gnorm']:.3f} "
                              f"fails={m['fails']:.0f} dt={m['dt']:.2f}s",
                              flush=True)
                if (step + 1) % self.tc.ckpt_every == 0:
                    self.save(state)
            except RuntimeError as e:       # device, kernel or collective
                restarts += 1
                self.restarts += 1
                print(f"[train] rank {self.rank} step {step} failed "
                      f"({type(e).__name__}: {e}); restart "
                      f"{restarts}/{self.tc.max_restarts}", flush=True)
                if restarts > self.tc.max_restarts:
                    raise
                state = self.restore() or self._init()
        self.save(state)
        return state


def _fresh_ckpt_dir(lead: bool, world: int) -> str:
    """A new directory under the caller's TMPDIR, made by rank 0 and shared
    with every rank, so that a run without a ``ckpt_dir`` neither resumes
    from nor overwrites another run's checkpoints."""
    path = [tempfile.mkdtemp(prefix="repro_ckpt_") if lead else None]
    if world > 1:
        dist.broadcast_object_list(path, src=0)
    return path[0]


def _global_y_shapes(y: dict, ctx: ShardCtx) -> dict:
    """Shapes of the reference's global y tree for this layout (sharded
    anchors (L?, tp, dp, shard)), as numpy placeholders for reshard_y."""
    def one(v):
        if isinstance(v, dict):
            a = tuple(v["anchor"].shape)
            if ctx.anchor_sharded:
                a = a[:-3] + (ctx.tp, ctx.dp, a[-1])
            return {"y": np.empty(tuple(v["y"].shape), np.float32),
                    "anchor": np.empty(a, np.float32)}
        return np.empty(tuple(v.shape), np.float32)
    return {grp: {k: one(v) for k, v in y[grp].items()} for grp in y}


def _local_y(restored: dict, fresh: dict, ctx: ShardCtx, rank: int,
             tp_rank: int, device) -> Optional[dict]:
    """The restored global y tree as this rank's state, or None when its
    structure or shapes do not fit."""
    want = _global_y_shapes(fresh, ctx)
    try:
        out = {}
        for grp in ("layers", "top"):
            out[grp] = {}
            for k, w in want[grp].items():
                r = restored[grp][k]
                if isinstance(w, dict):
                    if set(r) != {"y", "anchor"} or \
                            np.shape(r["y"]) != w["y"].shape or \
                            np.shape(r["anchor"]) != w["anchor"].shape:
                        return None
                    a = np.asarray(r["anchor"])
                    if ctx.anchor_sharded:
                        a = a[..., tp_rank:tp_rank + 1, rank:rank + 1, :]
                    out[grp][k] = {
                        "y": torch.as_tensor(np.asarray(r["y"]),
                                             device=device),
                        "anchor": torch.as_tensor(np.ascontiguousarray(a),
                                                  device=device)}
                else:
                    if isinstance(r, dict) or np.shape(r) != w.shape:
                        return None
                    out[grp][k] = torch.as_tensor(np.asarray(r),
                                                  device=device)
            if set(restored[grp]) != set(want[grp]):
                return None
        return out
    except (KeyError, TypeError):
        return None
