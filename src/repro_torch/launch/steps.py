"""Step builders and argument structs for every (arch x shape x mesh) cell;
counterpart of ``repro.launch.steps``.

Where the reference returns ``ShapeDtypeStruct`` stand-ins and a jitted
``shard_map`` step, each builder here returns ``(step_fn, arg_structs,
cfg, ctx)`` with

* ``arg_structs``: ``meta`` tensors of the reference's *global* shapes and
  dtypes, in the reference's tree (same keys, same leaf order); each leaf
  carries its placement as ``leaf.spec``, one entry per dim naming the mesh
  axis (or axes) the dim is split over, ``None`` where it is whole: the
  reference's ``PartitionSpec``.  :func:`local_structs` gives a rank's
  local shapes from them (the same on every rank: each split dim divides
  evenly, as ``shard_map`` requires);
* ``step_fn``: the step the port runs, taking this rank's local tensors:
  ``train/trainer.make_train_step``, :func:`_make_encdec_train_step`,
  ``models/serve.make_serve_step``, ``make_prefill`` and
  ``make_encdec_prefill``.  The serving caches keep the reference's
  leading TP axis (one entry on a rank), which the step strips and puts
  back, as the reference's ``shard_map`` body does.

The train step count, the decode position and the key are host values in
the port (a Python int and a key pair), not device tensors: their structs
keep the reference's dtypes and carry the host value :func:`local_structs`
gives for them (``leaf.host``).

Where the reference takes a jax mesh, the builders take a layout — a
``(data, model)`` or ``(pod, data, model)`` tuple or a
``launch/mesh.Layout`` — and build its process groups with
``launch/mesh.mesh_axes`` in the default group, which must hold the
layout's world (``launch/mesh.fake_world`` gives one without a card).
Keywords the reference does not have are the port's: ``prefetch`` (the
FSDP gather prefetch, ``ShardCtx.prefetch``), ``batch`` and ``seq`` (a
global batch and sequence that replace the shape's, for a run cut to a
card), ``opt_cfg`` (the optimizer, instead of the arch's default) and
``device`` (where the train step's own tensors go: the card unless another
is named; a serving step puts its tensors beside its arguments).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import random as _random
from repro_torch import resolve_device
from repro_torch.configs import registry, shapes as SH
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.launch.mesh import Layout, layout, mesh_axes
from repro_torch.models import encdec as ED
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (LeafMeta, ShardCtx, _psum,
                                         storage_shape)
from repro_torch.train import optim as O
from repro_torch.train import trainer as TR

_F32, _I32, _U32 = torch.float32, torch.int32, torch.uint32

# the default group and the groups built in it, per layout: a layout's
# groups are made once per group (``new_group`` is collective), and the
# group is held so that a new one is never mistaken for it
_GROUPS: dict = {}


def _axes(mesh: Layout):
    """(dp_axes, tp_axis) process groups of ``mesh`` in the default group."""
    world = dist.group.WORLD
    held = _GROUPS.get(mesh.shape)
    if held is None or held[0] is not world:
        held = _GROUPS[mesh.shape] = (world, mesh_axes(mesh.shape))
    return held[1]


def make_ctx(cfg: ModelConfig, mesh, *, grad_sync: str = "lq",
             qcfg: Optional[QSyncConfig] = None,
             seq_parallel: Optional[bool] = None,
             prefetch: bool = False) -> ShardCtx:
    mesh = layout(mesh)
    dp_axes, tp_axis = _axes(mesh)
    tp = mesh.shape[-1]
    dp = math.prod(mesh.shape[:-1])
    if seq_parallel is None:
        # SP everywhere except encoder-decoder (short decoder sequences)
        seq_parallel = cfg.family != "encdec" and tp > 1
    return ShardCtx(tp_axis=tp_axis, dp_axes=dp_axes, tp=tp, dp=dp,
                    qcfg=qcfg or QSyncConfig(), grad_sync=grad_sync,
                    seq_parallel=seq_parallel, prefetch=prefetch)


# ---------------------------------------------------------------------------
# structs
# ---------------------------------------------------------------------------

def _meta(shape, dtype, spec=(), host=None) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    t.spec = tuple(spec) + (None,) * (len(t.shape) - len(spec))
    t.host = host
    return t


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def local_shape(t: torch.Tensor, mesh) -> tuple:
    """A rank's shape of the global struct ``t`` on ``mesh``."""
    sizes = layout(mesh).axis_sizes
    out = []
    for d, ax in zip(t.shape, t.spec):
        names = () if ax is None else (ax,) if isinstance(ax, str) else ax
        n = math.prod(sizes[a] for a in names)
        if d % n:
            raise ValueError(f"dim {d} does not split over {names} ({n})")
        out.append(d // n)
    return tuple(out)


def local_structs(arg_structs, mesh):
    """Every rank's local arguments of a cell: a ``meta`` tensor of the
    rank's shape for each tensor leaf, the host value for the step count,
    position and key."""
    def one(t):
        if t.host is not None:
            return t.host
        return torch.empty(local_shape(t, mesh), dtype=t.dtype,
                           device="meta")
    return _tree_map(one, arg_structs)


def _dpa(mesh: Layout):
    dp = mesh.axis_names[:-1]
    return dp if len(dp) > 1 else dp[0]


def storage_spec(meta: LeafMeta, mesh: Layout) -> tuple:
    """The reference's ``storage_spec``: (L?, tp, dp, shard) split over
    the model and the data axes."""
    s = ("model", _dpa(mesh), None)
    return ((None,) + s) if meta.scanned else s


def _arch_cfg(arch: str, smoke: bool) -> ModelConfig:
    return registry.smoke_config(arch) if smoke else registry.config(arch)


def _metas_shapes(cfg: ModelConfig, ctx: ShardCtx):
    if cfg.family == "encdec":
        return ED.encdec_metas(cfg, ctx), ED.encdec_param_shapes(cfg, ctx)
    L = T.n_scan_steps(cfg)
    metas = T.all_metas(cfg, ctx)
    return metas, {grp: {k: storage_shape(m, ctx, L)
                         for k, m in metas[grp].items()} for grp in metas}


def _param_structs(cfg, ctx, mesh: Layout, dtype) -> dict:
    metas, shapes = _metas_shapes(cfg, ctx)
    return {grp: {k: _meta(shapes[grp][k], dtype,
                           storage_spec(metas[grp][k], mesh))
                  for k in sorted(metas[grp])} for grp in sorted(metas)}


# ---------------------------------------------------------------------------
# train cell
# ---------------------------------------------------------------------------

def train_cell(arch: str, shape_name: str, mesh, *, grad_sync: str = "lq",
               qcfg: Optional[QSyncConfig] = None, microbatch: int = 0,
               seq_parallel: Optional[bool] = None, smoke: bool = False,
               prefetch: bool = False, batch: Optional[int] = None,
               seq: Optional[int] = None,
               opt_cfg: Optional[O.OptConfig] = None, device=None):
    """Returns (step_fn, (state, batch) structs, cfg, ctx)."""
    mesh = layout(mesh)
    cfg = _arch_cfg(arch, smoke)
    sh = SH.SHAPES[shape_name]
    assert sh.kind == "train"
    ctx = make_ctx(cfg, mesh, grad_sync=grad_sync, qcfg=qcfg,
                   seq_parallel=seq_parallel, prefetch=prefetch)
    ov = registry.train_overrides(arch)
    if opt_cfg is None:
        opt_cfg = O.OptConfig(name=ov.get("opt_name", "adamw"),
                              state_dtype=ov.get("opt_state_dtype",
                                                 "float32"))
    mb = microbatch or ov.get("microbatch", 0)
    tc = TR.TrainConfig(microbatch=0 if smoke else mb)

    if cfg.family == "encdec":
        step_fn = _make_encdec_train_step(cfg, ctx, mesh, opt_cfg, tc,
                                          device)
        y = ED.encdec_y_init(cfg, ctx, device="meta")
    else:
        step_fn = TR.make_train_step(cfg, ctx, opt_cfg, tc, device)
        y = T.y_init(cfg, ctx, device="meta")
    dt = getattr(torch, opt_cfg.state_dtype)
    opt = {k: _param_structs(cfg, ctx, mesh, dt)
           for k in (("m", "v") if opt_cfg.name == "adamw" else ("m",))}
    state = {"params": _param_structs(cfg, ctx, mesh, _F32), "opt": opt,
             "y": _tree_map(lambda v: _meta(v.shape, v.dtype), y),
             "step": _meta((), _I32, host=0),
             "key": _meta((2,), _U32, host=_random.PRNGKey(0))}

    B = (sh.global_batch if not smoke else min(sh.global_batch, 8)) \
        if batch is None else batch
    S = (sh.seq_len if not smoke else 64) if seq is None else seq
    bspec = (_dpa(mesh),)
    batch_s = {
        "tokens": _meta((B, S), _I32, bspec),
        "targets": _meta((B, S), _I32, bspec),
        "mask": _meta((B, S), _F32, bspec),
    }
    if cfg.family == "vlm":
        batch_s["img"] = _meta((B, cfg.img_tokens, cfg.d_model), _F32, bspec)
    if cfg.family == "encdec":
        batch_s["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), _F32, bspec)
    return step_fn, (state, batch_s), cfg, ctx


def _make_encdec_train_step(cfg: ModelConfig, ctx: ShardCtx, mesh,
                            opt_cfg: O.OptConfig, tc: TR.TrainConfig,
                            device=None):
    """The encoder-decoder's train step (the reference builds it here, its
    launcher has no encdec path): step(state, batch) -> (state, {"loss"
    (the DP mean), "gnorm"}) on this rank's shards and rows.

    The loss and the gradients of ``make_encdec_loss_fn`` over the
    parameters and the zero telemetry; the global grad norm from each
    leaf's f32 sum of squares, summed over the DP ranks (and over the TP
    ranks for a leaf sliced over them) and added in the reference's leaf
    order (groups, then names, sorted); ``optim.apply_update``; each
    leaf's ``y`` from its telemetry gradient.  ``mesh`` keeps the
    reference's signature: the process groups come in ``ctx``."""
    device = resolve_device(device)
    metas = ED.encdec_metas(cfg, ctx)
    loss_fn = ED.make_encdec_loss_fn(cfg, ctx)
    depth = {"enc": cfg.enc_layers, "dec": cfg.n_layers, "top": 0}
    names = [(grp, k) for grp in sorted(metas) for k in sorted(metas[grp])]

    def leaves(tree: dict) -> dict:
        """Fresh leaves requiring grad, a stacked leaf as its layers."""
        return {grp: {k: ([v[i].detach().requires_grad_(True)
                           for i in range(depth[grp])] if depth[grp]
                          else v.detach().requires_grad_(True))
                      for k, v in t.items()} for grp, t in tree.items()}

    def grads(lv: dict) -> dict:
        return {grp: {k: (torch.stack([t.grad for t in v])
                          if isinstance(v, list) else v.grad)
                      for k, v in t.items()} for grp, t in lv.items()}

    def step_fn(state, batch):
        params, opt, y, step, key = (state["params"], state["opt"],
                                     state["y"], state["step"], state["key"])
        kstep = _random.fold_in(key, step)
        p_in = leaves(params)
        t_in = leaves(ED.encdec_tele_zeros(cfg, ctx, device=device))
        loss, metrics = loss_fn(p_in, t_in, batch, kstep, y)
        loss.backward()
        gp, gt = grads(p_in), grads(t_in)
        sums = TR.psum_dp(torch.stack(
            [torch.sum(gp[g][k].to(_F32) ** 2) for g, k in names]), ctx)
        if ctx.tp > 1:
            sliced = torch.tensor([not metas[g][k].tp_replicated
                                   for g, k in names], device=sums.device)
            sums = torch.where(sliced, _psum(sums, ctx), sums)
        sq = torch.zeros((), dtype=_F32, device=sums.device)
        for s in sums:
            sq = sq + s
        gnorm = torch.sqrt(sq)
        params2, opt2 = O.apply_update(params, gp, opt, step, opt_cfg, gnorm)
        y2 = {grp: {k: TR._y_update(y[grp][k], gt[grp][k], tc)
                    for k in y[grp]} for grp in y}
        loss_rep = TR.psum_dp(metrics["loss"].reshape(1), ctx)[0] / ctx.dp
        new_state = {"params": params2, "opt": opt2, "y": y2,
                     "step": step + 1, "key": key}
        return new_state, {"loss": loss_rep, "gnorm": gnorm}

    return step_fn


# ---------------------------------------------------------------------------
# serve cells
# ---------------------------------------------------------------------------

def _cache_global(cfg, ctx, cstruct, B_global, replicate_batch,
                  mesh: Layout):
    """Local cache shapes -> global structs with their specs: a leading
    tp axis, the batch dim split over dp unless replicated.  int8 k/v and
    f32 scales when quantized (implied by the ``*_scale`` leaves)."""
    structs = {}
    quant = "k_scale" in cstruct
    for k, s in cstruct.items():
        bpos = 0 if k.startswith("tail") else 1   # (L, B, ...) vs (B, ...)
        gs = list(s)
        spec = [None] * (len(gs) + 1)
        spec[0] = "model"
        if not replicate_batch:
            gs[bpos] = B_global
            spec[bpos + 1] = _dpa(mesh)
        structs[k] = _meta((ctx.tp, *gs), SV.cache_dtype(k, quant), spec)
    return structs


def _strip_tp(cache: dict) -> dict:
    return {k: v[0] for k, v in cache.items()}


def _add_tp(cache: dict) -> dict:
    return {k: v[None] for k, v in cache.items()}


def decode_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False,
                kv_quant: bool = False):
    """serve_step: one new token against a seq_len-deep cache."""
    mesh = layout(mesh)
    cfg = _arch_cfg(arch, smoke)
    sh = SH.SHAPES[shape_name]
    assert sh.kind in ("decode", "long_decode")
    if not SH.applicable(cfg.family, shape_name):
        raise ValueError(f"{arch} skips {shape_name} (full attention)")
    if kv_quant and cfg.family in ("ssm", "hybrid", "encdec"):
        kv_quant = False                 # no full-context KV cache to quantize
    ctx = make_ctx(cfg, mesh, seq_parallel=False)

    B = sh.global_batch if not smoke else min(sh.global_batch, 4)
    S = sh.seq_len if not smoke else 64
    replicate_batch = B < ctx.dp
    B_loc = B if replicate_batch else B // ctx.dp

    step = SV.make_serve_step(cfg, ctx, kv_quant=kv_quant)
    cstruct = SV.cache_struct(cfg, ctx, B_loc, S, kv_quant=kv_quant)
    cache = _cache_global(cfg, ctx, cstruct, B, replicate_batch, mesh)
    bspec = (None,) if replicate_batch else (_dpa(mesh),)

    def step_fn(params, cache, tokens, pos, key):
        nxt, nc = step(params, _strip_tp(cache), tokens, pos, key)
        return nxt, _add_tp(nc)

    args = (_param_structs(cfg, ctx, mesh, torch.bfloat16), cache,
            _meta((B, 1), _I32, bspec), _meta((), _I32, host=S - 1),
            _meta((2,), _U32, host=_random.PRNGKey(0)))
    return step_fn, args, cfg, ctx


def prefill_cell(arch: str, shape_name: str, mesh, *, smoke: bool = False):
    mesh = layout(mesh)
    cfg = _arch_cfg(arch, smoke)
    sh = SH.SHAPES[shape_name]
    assert sh.kind == "prefill"
    ctx = make_ctx(cfg, mesh, seq_parallel=False)
    B = sh.global_batch if not smoke else 4
    S = sh.seq_len if not smoke else 64
    bspec = (None,) if B < ctx.dp else (_dpa(mesh),)
    params = _param_structs(cfg, ctx, mesh, torch.bfloat16)
    key = _meta((2,), _U32, host=_random.PRNGKey(0))

    if cfg.family == "encdec":
        pf = SV.make_encdec_prefill(cfg, ctx)

        def step_fn(params, frames, tokens, key):
            last, cache = pf(params, frames, tokens, key)
            return last, _add_tp(cache)

        args = (params, _meta((B, cfg.enc_seq, cfg.d_model), _F32, bspec),
                _meta((B, S), _I32, bspec), key)
        return step_fn, args, cfg, ctx

    pf = SV.make_prefill(cfg, ctx)
    if cfg.family == "vlm":
        def step_fn(params, tokens, key, img):
            last, cache = pf(params, tokens, key, img)
            return last, _add_tp(cache)

        args = (params, _meta((B, S - cfg.img_tokens), _I32, bspec), key,
                _meta((B, cfg.img_tokens, cfg.d_model), _F32, bspec))
        return step_fn, args, cfg, ctx

    def step_fn(params, tokens, key):
        last, cache = pf(params, tokens, key)
        return last, _add_tp(cache)

    args = (params, _meta((B, S), _I32, bspec), key)
    return step_fn, args, cfg, ctx


def build_cell(arch: str, shape_name: str, mesh, **kw):
    kind = SH.SHAPES[shape_name].kind
    if kind == "train":
        return train_cell(arch, shape_name, mesh, **kw)
    if kind == "prefill":
        return prefill_cell(arch, shape_name, mesh,
                            smoke=kw.get("smoke", False))
    return decode_cell(arch, shape_name, mesh, smoke=kw.get("smoke", False),
                       kv_quant=kw.get("kv_quant", False))
