"""Model assembly: parameter metas, init, and the training forward pass;
counterpart of ``repro.models.transformer``.

Families covered here: dense, moe, ssm, hybrid (RG-LRU), vlm; the
encoder-decoder (whisper) lives in ``models/encdec.py`` on the same
substrate.  The metas (and so the storage, ``y`` and telemetry shapes)
are the reference's for every family.

Parameters arrive as each rank's ZeRO-3 storage slices (``models/
sharding.py``) and each layer re-gathers its weights through the FSDP
gather, whose backward runs the paper's quantized reduce-scatter (after
the TP psum of a replicated leaf's gradient).  With ``ctx.seq_parallel``
the residual stream is sliced over the TP ranks after the embedding and
gathered back before the vocab-parallel cross entropy.  With
``ctx.remat`` each layer's body, its gathers included, runs under
``torch.utils.checkpoint`` (non-reentrant): the backward re-gathers and
recomputes the layer, as the reference's ``jax.checkpoint(body)`` does.
Each iteration of a forward layer loop runs inside a
``torch.profiler.record_function(LAYER_SPAN)`` span (a prefetching loop's
span holds the next layer's gather issues too): the layer bodies that the
dry run's overlap audit reads, and the layers of a profiler trace.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as _random
from repro_torch import resolve_device
from repro_torch.models import layers as LY
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (LeafMeta, ShardCtx, all_gather_tp,
                                         anchor_shape, gather_param,
                                         gather_param_async,
                                         gather_param_wait, init_leaf,
                                         leaf_nb, leaf_tele_width, leaf_y0,
                                         make_gathers, make_split_gathers,
                                         tp_index)

# families whose training forward pass make_loss_fn builds (the
# reference's; encdec has its own, models/encdec.py)
FORWARD_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
# the profiler span of one forward layer iteration
LAYER_SPAN = "repro_torch.layer"


# ---------------------------------------------------------------------------
# Leaf metas per family (the reference's, for every family)
# ---------------------------------------------------------------------------

def _attn_metas(cfg: ModelConfig, ctx: ShardCtx, prefix: str = "",
                kv: Optional[int] = None) -> dict:
    D, hd = cfg.d_model, cfg.head_dim
    h_loc = LY.local_heads(cfg, ctx)
    repl = LY.head_repl(cfg, ctx)
    kv = cfg.n_kv if kv is None else kv
    m = {
        f"{prefix}wq": LeafMeta((D, h_loc * hd), tp_dim=1, tp_repl=repl),
        f"{prefix}wk": LeafMeta((D, kv * hd), tp_dim=None),
        f"{prefix}wv": LeafMeta((D, kv * hd), tp_dim=None),
        f"{prefix}wo": LeafMeta((h_loc * hd, D), tp_dim=0, tp_repl=repl),
    }
    if cfg.qk_norm:
        m[f"{prefix}qn"] = LeafMeta((hd,), tp_dim=None, init="ones")
        m[f"{prefix}kn"] = LeafMeta((hd,), tp_dim=None, init="ones")
    return m


def _mlp_metas(cfg: ModelConfig, ctx: ShardCtx, prefix: str = "") -> dict:
    D, F = cfg.d_model, cfg.d_ff
    f_loc = F // ctx.tp
    if cfg.act == "swiglu":
        return {
            f"{prefix}wg": LeafMeta((D, f_loc), tp_dim=1),
            f"{prefix}wu": LeafMeta((D, f_loc), tp_dim=1),
            f"{prefix}wd": LeafMeta((f_loc, D), tp_dim=0),
        }
    return {
        f"{prefix}wi": LeafMeta((D, f_loc), tp_dim=1),
        f"{prefix}wd": LeafMeta((f_loc, D), tp_dim=0),
    }


def _moe_metas(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    e_loc = E // ctx.tp if E >= ctx.tp else E
    m = {
        "router": LeafMeta((D, E), tp_dim=None),
        "w1": LeafMeta((e_loc, D, F), tp_dim=0),
        "w2": LeafMeta((e_loc, F, D), tp_dim=0),
    }
    if cfg.act == "swiglu":
        m["w3"] = LeafMeta((e_loc, D, F), tp_dim=0)
    return m


def _ssm_metas(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    D = cfg.d_model
    inner = cfg.ssm_expand * D
    i_loc = inner // ctx.tp
    P = cfg.ssm_headdim
    h_loc = i_loc // P
    N = cfg.ssm_state
    W = cfg.conv_width
    return {
        "wz": LeafMeta((D, i_loc), tp_dim=1),
        "wx": LeafMeta((D, i_loc), tp_dim=1),
        "wbc": LeafMeta((D, 2 * N), tp_dim=None),
        "wdt": LeafMeta((D, h_loc), tp_dim=1),
        "conv_x": LeafMeta((W, i_loc), tp_dim=1, init="normal", init_scale=0.5),
        "conv_bc": LeafMeta((W, 2 * N), tp_dim=None, init="normal",
                            init_scale=0.5),
        "A_log": LeafMeta((h_loc,), tp_dim=0, init="a_log"),
        "D": LeafMeta((h_loc,), tp_dim=0, init="ones"),
        "dt_bias": LeafMeta((h_loc,), tp_dim=0, init="dt_bias"),
        "norm": LeafMeta((i_loc,), tp_dim=0, init="ones"),
        "wo": LeafMeta((i_loc, D), tp_dim=0),
    }


def _rec_metas(cfg: ModelConfig, ctx: ShardCtx, prefix: str) -> dict:
    D = cfg.d_model
    C = (cfg.lru_width or cfg.d_model) // ctx.tp
    W = cfg.conv_width
    return {
        f"{prefix}wy": LeafMeta((D, C), tp_dim=1),
        f"{prefix}wx": LeafMeta((D, C), tp_dim=1),
        f"{prefix}conv": LeafMeta((W, C), tp_dim=1, init="normal",
                                  init_scale=0.5),
        f"{prefix}w_r": LeafMeta((C,), tp_dim=0, init="normal", init_scale=8.0),
        f"{prefix}b_r": LeafMeta((C,), tp_dim=0, init="zeros"),
        f"{prefix}w_i": LeafMeta((C,), tp_dim=0, init="normal", init_scale=8.0),
        f"{prefix}b_i": LeafMeta((C,), tp_dim=0, init="zeros"),
        f"{prefix}lam": LeafMeta((C,), tp_dim=0, init="a_log"),
        f"{prefix}wo": LeafMeta((C, D), tp_dim=0),
    }


def block_metas(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    """Metas of one stacked layer (or super-unit for hybrid)."""
    D = cfg.d_model

    def ln():
        return LeafMeta((D,), tp_dim=None, init="ones")

    if cfg.family in ("dense", "vlm"):
        return {"ln1": ln(), "ln2": ln(),
                **_attn_metas(cfg, ctx), **_mlp_metas(cfg, ctx)}
    if cfg.family == "moe":
        return {"ln1": ln(), "ln2": ln(),
                **_attn_metas(cfg, ctx), **_moe_metas(cfg, ctx)}
    if cfg.family == "ssm":
        return {"ln1": ln(), **_ssm_metas(cfg, ctx)}
    if cfg.family == "hybrid":
        m: dict = {}
        for p in ("r1_", "r2_"):
            m[f"{p}ln1"] = ln()
            m[f"{p}ln2"] = ln()
            m.update(_rec_metas(cfg, ctx, p))
            m.update({f"{p}{k}": v for k, v in _mlp_metas(cfg, ctx).items()})
        m["at_ln1"] = ln()
        m["at_ln2"] = ln()
        m.update(_attn_metas(cfg, ctx, "at_"))
        m.update({f"at_{k}": v for k, v in _mlp_metas(cfg, ctx).items()})
        return m
    raise ValueError(cfg.family)


def top_metas(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    V, D = cfg.vocab, cfg.d_model
    v_loc = -(-V // ctx.tp)
    m = {
        "embed": LeafMeta((v_loc, D), tp_dim=0, scanned=False, init="embed"),
        "final_norm": LeafMeta((D,), tp_dim=None, scanned=False, init="ones"),
    }
    if not cfg.tie_embeddings:
        m["lm_head"] = LeafMeta((v_loc, D), tp_dim=0, scanned=False,
                                init="embed")
    if cfg.family == "hybrid":
        for t in range(cfg.n_layers % 3):
            p = f"tail{t}_"
            m[f"{p}ln1"] = LeafMeta((D,), tp_dim=None, scanned=False,
                                    init="ones")
            m[f"{p}ln2"] = LeafMeta((D,), tp_dim=None, scanned=False,
                                    init="ones")
            for k, v in _rec_metas(cfg, ctx, p).items():
                m[k] = dataclasses.replace(v, scanned=False)
            for k, v in _mlp_metas(cfg, ctx, p).items():
                m[k] = dataclasses.replace(v, scanned=False)
    return m


def n_scan_steps(cfg: ModelConfig) -> int:
    return cfg.n_layers // 3 if cfg.family == "hybrid" else cfg.n_layers


def all_metas(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    return {"layers": block_metas(cfg, ctx), "top": top_metas(cfg, ctx)}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, ctx: ShardCtx, key, *,
                dp_rank: Optional[int] = None, tp_rank: int = 0,
                device=None) -> dict:
    """The reference's ``init_params``: one key per leaf, split in sorted
    leaf order (layers, then top).  Global storage arrays, or with
    ``dp_rank`` the slices of the rank at (``tp_rank``, ``dp_rank``) (only
    their elements drawn)."""
    metas = all_metas(cfg, ctx)
    L = n_scan_steps(cfg)
    out: dict = {"layers": {}, "top": {}}
    ks = _random.split(key, len(metas["layers"]) + len(metas["top"]))
    i = 0
    for grp in ("layers", "top"):
        for name, meta in sorted(metas[grp].items()):
            out[grp][name] = init_leaf(ks[i], meta, ctx, L, dp_rank=dp_rank,
                                       tp_rank=tp_rank, device=device)
            i += 1
    return out


def y_init(cfg: ModelConfig, ctx: ShardCtx, value: float = 1.0, *,
           device=None) -> dict:
    """Initial distance-bound state, one per-bucket vector per leaf (per
    layer): (L, nb) stacked, (nb,) top-level; anchored leaves carry
    ``{"y", "anchor"}`` with a zero anchor, the rank's ``(L?, 1, 1,
    shard)`` slice when sharded, the full ``(L?, m)`` when replicated."""
    device = resolve_device(device)
    metas = all_metas(cfg, ctx)
    L = n_scan_steps(cfg)

    def leaf(meta, scanned):
        nb = leaf_nb(meta, ctx)
        shape = (L, nb) if scanned else (nb,)
        y = torch.full(shape, leaf_y0(meta, ctx, value), dtype=torch.float32,
                       device=device)
        if not ctx.anchor_grads:
            return y
        a_shape = anchor_shape(meta, ctx, L if scanned else 0)
        if ctx.anchor_sharded:
            a_shape = a_shape[:-3] + (1, 1, a_shape[-1])
        return {"y": y, "anchor": torch.zeros(a_shape, dtype=torch.float32,
                                              device=device)}

    return {"layers": {k: leaf(m, True) for k, m in metas["layers"].items()},
            "top": {k: leaf(m, False) for k, m in metas["top"].items()}}


def tele_zeros(cfg: ModelConfig, ctx: ShardCtx, *, device=None) -> dict:
    """Zero tele inputs, one per leaf: (L, width) stacked, (width,) top."""
    device = resolve_device(device)
    metas = all_metas(cfg, ctx)
    L = n_scan_steps(cfg)
    return {
        "layers": {k: torch.zeros((L, leaf_tele_width(m, ctx)),
                                  dtype=torch.float32, device=device)
                   for k, m in metas["layers"].items()},
        "top": {k: torch.zeros((leaf_tele_width(m, ctx),),
                               dtype=torch.float32, device=device)
                for k, m in metas["top"].items()},
    }


# ---------------------------------------------------------------------------
# Blocks (operating on gathered weights)
# ---------------------------------------------------------------------------

def _moe_apply(x_norm: torch.Tensor, wts: dict, cfg: ModelConfig,
               ctx: ShardCtx):
    """Token-sliced MoE; returns (the full out in x_norm's layout, aux)."""
    B, S, D = x_norm.shape
    if ctx.seq_parallel or ctx.tp == 1:
        out, aux = MOE.moe_mlp(x_norm.reshape(B * S, D), wts, cfg, ctx)
        return out.reshape(B, S, D), aux
    # not SP: slice the tokens over tp, compute, gather back
    t_loc = (B * S) // ctx.tp
    i = tp_index(ctx)
    sl = x_norm.reshape(B * S, D)[i * t_loc:(i + 1) * t_loc]
    out, aux = MOE.moe_mlp(sl, wts, cfg, ctx)
    return all_gather_tp(out, ctx, axis=0).reshape(B, S, D), aux


def dense_block(x: torch.Tensor, wts: dict, cfg: ModelConfig, ctx: ShardCtx,
                positions: torch.Tensor, window: int = 0):
    a_in = LY.rms_norm(x, wts["ln1"], cfg.norm_eps)
    xg = LY.sp_enter(a_in, ctx)
    att = LY.attention(xg, wts, cfg, ctx, positions=positions, causal=True,
                       window=window)
    x = x + LY.attn_exit(att, cfg, ctx)
    m_in = LY.rms_norm(x, wts["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        out, aux = _moe_apply(m_in, wts, cfg, ctx)
        return x + out, aux
    mg = LY.sp_enter(m_in, ctx)
    x = x + LY.sp_exit(LY.mlp(mg, wts, cfg), ctx)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def ssm_block(x: torch.Tensor, wts: dict, cfg: ModelConfig, ctx: ShardCtx
              ) -> torch.Tensor:
    a_in = LY.rms_norm(x, wts["ln1"], cfg.norm_eps)
    xg = LY.sp_enter(a_in, ctx)
    out, _ = SSM.mamba2_block(xg, wts, cfg, ctx)
    return x + LY.sp_exit(out, ctx)


def _sub(wts: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in wts.items() if k.startswith(prefix)}


def _recurrent_layer(x: torch.Tensor, sw: dict, cfg: ModelConfig,
                     ctx: ShardCtx) -> torch.Tensor:
    """One recurrent layer of the hybrid: the RG-LRU block, then its MLP."""
    a_in = LY.rms_norm(x, sw["ln1"], cfg.norm_eps)
    xg = LY.sp_enter(a_in, ctx)
    out, _ = RG.recurrent_block(xg, sw, cfg, ctx)
    x = x + LY.sp_exit(out, ctx)
    m_in = LY.rms_norm(x, sw["ln2"], cfg.norm_eps)
    mg = LY.sp_enter(m_in, ctx)
    return x + LY.sp_exit(LY.mlp(mg, sw, cfg), ctx)


def hybrid_unit(x: torch.Tensor, wts: dict, cfg: ModelConfig, ctx: ShardCtx,
                positions: torch.Tensor) -> torch.Tensor:
    for p in ("r1_", "r2_"):
        x = _recurrent_layer(x, _sub(wts, p), cfg, ctx)
    x, _ = dense_block(x, _sub(wts, "at_"),
                       dataclasses.replace(cfg, family="dense"), ctx,
                       positions, window=cfg.window)
    return x


# ---------------------------------------------------------------------------
# Training forward + loss
# ---------------------------------------------------------------------------

def _leaf_key(key, name: str):
    # deterministic across processes (never Python hash(): it is salted)
    return _random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def _gather_tree(params: dict, metas: dict, ctx: ShardCtx, y: dict, key,
                 tele: dict, gathers, dtype=torch.bfloat16) -> dict:
    return {name: gather_param(params[name], metas[name], ctx, y[name],
                               _leaf_key(key, name), tele[name], gathers,
                               dtype)
            for name in params}


def _layer(tree: dict, i: int) -> dict:
    """Layer i's entry of every stacked leaf (a tensor row, a list item, or
    an anchored {"y", "anchor"} dict of those)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _prefetch_layer_scan(x0, params_l: dict, metas_l: dict, ctx: ShardCtx,
                         y_l, tele_l, L: int, split, key_fn, apply_fn,
                         remat: bool):
    """Layer loop issuing layer i+1's FSDP gathers while layer i computes.

    Layer i's body waits for its issued handles; in the backward's
    recompute (``remat``) the handles are spent and the body gathers
    again, monolithically: the same bits, so the same saved tensors and
    gradients as the serial loop."""
    gathers = make_gathers(ctx)
    pending: dict = {}

    def issue(i):
        lp, ly, lt = _layer(params_l, i), _layer(y_l, i), _layer(tele_l, i)
        kl = key_fn(i)
        pending[i] = {name: gather_param_async(lp[name], metas_l[name], ctx,
                                               ly[name], _leaf_key(kl, name),
                                               lt[name], split)
                      for name in lp}

    def body(xcur, i):
        bufs = pending.pop(i, None)
        if bufs is None:
            wts = _gather_tree(_layer(params_l, i), metas_l, ctx,
                               _layer(y_l, i), key_fn(i), _layer(tele_l, i),
                               gathers)
        else:
            wts = {name: gather_param_wait(bufs[name], metas_l[name], ctx,
                                           split) for name in bufs}
        return apply_fn(xcur, wts)

    aux = torch.zeros((), dtype=torch.float32, device=x0.device)
    x = x0
    for i in range(L):
        with torch.profiler.record_function(LAYER_SPAN):
            if i == 0:
                issue(0)
            if i < L - 1:
                issue(i + 1)
            x, a = (checkpoint(body, x, i, use_reentrant=False,
                               preserve_rng_state=False) if remat
                    else body(x, i))
        aux = aux + a
    return x, aux


def make_loss_fn(cfg: ModelConfig, ctx: ShardCtx) -> Callable:
    """Returns loss_fn(params, tele, batch, key, y) -> (loss, metrics).

    params: one rank's storage slices (a stacked leaf may also be a list
    of per-layer slices); tele: zeros requiring grad (leaf_tele_width per
    leaf, per layer); batch: {"tokens": (B, S) int, "targets": (B, S) int,
    "mask": (B, S) f32; vlm also "img": (B, Timg, D)}, the DP rank's rows
    (the same on every TP rank of a DP group).  The loss is TP-global and
    DP-local (the gather's backward takes the DP mean); the first return
    is it divided by tp, the second's "loss" the loss itself.  An encdec
    config raises ``ValueError`` (its loss is ``models/encdec.py``'s)."""
    metas = all_metas(cfg, ctx)
    gathers = make_gathers(ctx)
    split = make_split_gathers(ctx) if ctx.prefetch else None
    L = n_scan_steps(cfg)

    def loss_fn(params, tele, batch, key, y):
        tokens = batch["tokens"]
        B, S = tokens.shape
        kt = _random.fold_in(key, 0)

        emb = gather_param(params["top"]["embed"], metas["top"]["embed"], ctx,
                           y["top"]["embed"], _leaf_key(kt, "embed"),
                           tele["top"]["embed"], gathers)
        x = LY.vp_embed(tokens, emb, ctx) * cfg.emb_scale
        if cfg.family == "vlm":
            x = torch.cat([batch["img"].to(x.dtype), x], dim=1)
        S_full = x.shape[1]
        positions = torch.arange(S_full, dtype=torch.int32, device=x.device)
        if ctx.seq_parallel and ctx.tp > 1:
            x = LY.token_slice(x, ctx)

        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def apply_block(xcur, wts):
            if cfg.family == "ssm":
                return ssm_block(xcur, wts, cfg, ctx), zero
            if cfg.family == "hybrid":
                return hybrid_unit(xcur, wts, cfg, ctx, positions), zero
            return dense_block(xcur, wts, cfg, ctx, positions)

        def key_fn(i):
            return _random.fold_in(key, i + 1)

        if ctx.prefetch:
            x, aux = _prefetch_layer_scan(
                x, params["layers"], metas["layers"], ctx, y["layers"],
                tele["layers"], L, split, key_fn, apply_block, ctx.remat)
        else:
            def body(xcur, i):
                wts = _gather_tree(_layer(params["layers"], i),
                                   metas["layers"], ctx, _layer(y["layers"], i),
                                   key_fn(i), _layer(tele["layers"], i),
                                   gathers)
                return apply_block(xcur, wts)

            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(L):
                with torch.profiler.record_function(LAYER_SPAN):
                    x, a = (checkpoint(body, x, i, use_reentrant=False,
                                       preserve_rng_state=False)
                            if ctx.remat else body(x, i))
                aux = aux + a

        # the hybrid's tail layers (n_layers % 3, not stacked)
        if cfg.family == "hybrid":
            for t in range(cfg.n_layers % 3):
                p = f"tail{t}_"
                kl = _random.fold_in(key, 10_000 + t)
                sw = {k[len(p):]: gather_param(
                    params["top"][k], metas["top"][k], ctx, y["top"][k],
                    _leaf_key(kl, k), tele["top"][k], gathers)
                    for k in metas["top"] if k.startswith(p)}
                x = _recurrent_layer(x, sw, cfg, ctx)

        fn = gather_param(params["top"]["final_norm"],
                          metas["top"]["final_norm"], ctx,
                          y["top"]["final_norm"], _leaf_key(kt, "fn"),
                          tele["top"]["final_norm"], gathers)
        x = LY.rms_norm(x, fn, cfg.norm_eps)
        if cfg.tie_embeddings:
            head = emb
        else:
            head = gather_param(params["top"]["lm_head"],
                                metas["top"]["lm_head"], ctx,
                                y["top"]["lm_head"], _leaf_key(kt, "head"),
                                tele["top"]["lm_head"], gathers)

        targets = batch["targets"]
        mask = batch.get("mask")
        if cfg.family == "vlm":
            timg = batch["img"].shape[1]
            pad_t = torch.zeros((B, timg), dtype=targets.dtype,
                                device=targets.device)
            targets = torch.cat([pad_t, targets], dim=1)
            pad_m = torch.zeros((B, timg), dtype=torch.float32,
                                device=targets.device)
            m0 = (torch.ones((B, S), dtype=torch.float32,
                             device=targets.device)
                  if mask is None else mask.to(torch.float32))
            mask = torch.cat([pad_m, m0], dim=1)

        if ctx.seq_parallel and ctx.tp > 1:
            # the vocab-parallel CE needs every token on every rank (the
            # vocab is sharded over tp too): gather the tokens back
            x = LY.sp_enter(x, ctx)
        nll_sum, cnt = LY.ce_sum(x.reshape(-1, cfg.d_model), head,
                                 targets.reshape(-1), ctx,
                                 None if mask is None else mask.reshape(-1))
        loss = nll_sum / torch.clamp_min(cnt, 1.0)
        loss = loss + 0.01 * aux
        # the loss is replicated over tp and every TP collective's backward
        # is its transpose, so 1/tp makes each rank's gradient exact
        return loss / ctx.tp, {"loss": loss.detach(), "aux": aux.detach()}

    return loss_fn
