"""Encoder-decoder backbone (Whisper-style) on the shared substrate;
counterpart of ``repro.models.encdec``.

The audio conv frontend is a stub, as the reference's: the batch carries
precomputed frame embeddings (B, enc_seq, D).  The backbone: bidirectional
encoder self-attention, causal decoder self-attention, decoder
cross-attention over the encoder's output, GELU MLPs, MHA (n_kv ==
n_heads).  The parameter tree has three groups, ``enc`` (stacked over
``enc_layers``), ``dec`` (stacked over ``n_layers``) and ``top``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import random as _random
from repro_torch import resolve_device
from repro_torch.models import layers as LY
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (LeafMeta, ShardCtx, anchor_shape,
                                         gather_param, init_leaf, leaf_nb,
                                         leaf_tele_width, leaf_y0,
                                         make_gathers, make_split_gathers,
                                         psum_tp, storage_shape)
from repro_torch.models.transformer import (LAYER_SPAN, _attn_metas,
                                            _gather_tree, _layer, _leaf_key,
                                            _mlp_metas,
                                            _prefetch_layer_scan)


def enc_block_metas(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    D = cfg.d_model

    def ln():
        return LeafMeta((D,), tp_dim=None, init="ones")

    return {"ln1": ln(), "ln2": ln(),
            **_attn_metas(cfg, ctx), **_mlp_metas(cfg, ctx)}


def dec_block_metas(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    D = cfg.d_model

    def ln():
        return LeafMeta((D,), tp_dim=None, init="ones")

    return {"ln1": ln(), "ln2": ln(), "ln3": ln(),
            **_attn_metas(cfg, ctx),
            **_attn_metas(cfg, ctx, prefix="x_"),
            **_mlp_metas(cfg, ctx)}


def encdec_metas(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    V, D = cfg.vocab, cfg.d_model
    v_loc = -(-V // ctx.tp)
    return {
        "enc": enc_block_metas(cfg, ctx),
        "dec": dec_block_metas(cfg, ctx),
        "top": {
            "embed": LeafMeta((v_loc, D), tp_dim=0, scanned=False,
                              init="embed"),
            "enc_norm": LeafMeta((D,), tp_dim=None, scanned=False,
                                 init="ones"),
            "final_norm": LeafMeta((D,), tp_dim=None, scanned=False,
                                   init="ones"),
            "lm_head": LeafMeta((v_loc, D), tp_dim=0, scanned=False,
                                init="embed"),
        },
    }


def _groups(cfg: ModelConfig):
    """(group, layers): the reference's order of the three groups."""
    return (("enc", cfg.enc_layers), ("dec", cfg.n_layers), ("top", 1))


def init_encdec_params(cfg: ModelConfig, ctx: ShardCtx, key, *,
                       dp_rank=None, tp_rank: int = 0, device=None) -> dict:
    """The reference's init: one split of ``key`` over every leaf, the
    groups in order (enc, dec, top) and each group's leaves sorted.  Global
    storage arrays, or with ``dp_rank`` the rank's slices (as
    ``transformer.init_params``)."""
    metas = encdec_metas(cfg, ctx)
    out: dict = {"enc": {}, "dec": {}, "top": {}}
    ks = _random.split(key, sum(len(v) for v in metas.values()))
    i = 0
    for grp, L in _groups(cfg):
        for name, meta in sorted(metas[grp].items()):
            out[grp][name] = init_leaf(ks[i], meta, ctx, L, dp_rank=dp_rank,
                                       tp_rank=tp_rank, device=device)
            i += 1
    return out


def encdec_param_shapes(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    """Global storage shapes of the parameter tree (tuples; nothing is
    allocated)."""
    metas = encdec_metas(cfg, ctx)
    return {grp: {name: storage_shape(meta, ctx, L)
                  for name, meta in metas[grp].items()}
            for grp, L in _groups(cfg)}


def encdec_y_init(cfg: ModelConfig, ctx: ShardCtx, value: float = 1.0, *,
                  device=None) -> dict:
    """Per-leaf, per-bucket initial distance bounds, as
    ``transformer.y_init``: (L, nb) stacked, (nb,) top; anchored leaves
    carry ``{"y", "anchor"}`` (the rank's slice when sharded)."""
    device = resolve_device(device)
    metas = encdec_metas(cfg, ctx)

    def leaf(m, L):
        shape = (L, leaf_nb(m, ctx)) if L else (leaf_nb(m, ctx),)
        yv = torch.full(shape, leaf_y0(m, ctx, value), dtype=torch.float32,
                        device=device)
        if not ctx.anchor_grads:
            return yv
        a_shape = anchor_shape(m, ctx, L)
        if ctx.anchor_sharded:
            a_shape = a_shape[:-3] + (1, 1, a_shape[-1])
        return {"y": yv, "anchor": torch.zeros(a_shape, dtype=torch.float32,
                                               device=device)}

    return {grp: {k: leaf(m, L if grp != "top" else 0)
                  for k, m in metas[grp].items()}
            for grp, L in _groups(cfg)}


def encdec_tele_zeros(cfg: ModelConfig, ctx: ShardCtx, *, device=None
                      ) -> dict:
    """Zero tele inputs, one per leaf: (L, width) stacked, (width,) top."""
    device = resolve_device(device)
    metas = encdec_metas(cfg, ctx)
    return {grp: {k: torch.zeros(((L,) if grp != "top" else ()) +
                                 (leaf_tele_width(m, ctx),),
                                 dtype=torch.float32, device=device)
                  for k, m in metas[grp].items()}
            for grp, L in _groups(cfg)}


def cross_attention(xg: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, w: dict, cfg: ModelConfig,
                    ctx: ShardCtx) -> torch.Tensor:
    """Decoder cross-attention.  xg: (B, Sd, D); mem_k/v: (B, Se, KV, hd)
    precomputed."""
    B, Sd, D = xg.shape
    hd = cfg.head_dim
    h_loc = LY.local_heads(cfg, ctx)
    q = (xg @ w["x_wq"]).reshape(B, Sd, h_loc, hd)
    k_h = LY._expand_kv(mem_k, cfg, ctx)       # take(mem_k, kv_map, axis=2)
    v_h = LY._expand_kv(mem_v, cfg, ctx)
    mask = torch.ones((Sd, mem_k.shape[1]), dtype=torch.bool,
                      device=xg.device)
    out = LY._softmax_attend(q, k_h, v_h, mask, float(1.0 / np.sqrt(hd)))
    return out.reshape(B, Sd, h_loc * hd) @ w["x_wo"]


def make_encdec_loss_fn(cfg: ModelConfig, ctx: ShardCtx):
    """Returns loss_fn(params, tele, batch, key, y) -> (loss / tp, metrics).

    batch: {"frames": (B, Se, D) f32, "tokens"/"targets"/"mask": (B, Sd)};
    params, tele and y are {"enc", "dec", "top"} trees (a stacked leaf may
    be a list of per-layer slices, as ``transformer.make_loss_fn`` takes
    it).  The decoder's layer keys fold in 1000 + i, the encoder's i + 1."""
    metas = encdec_metas(cfg, ctx)
    gathers = make_gathers(ctx)
    split = make_split_gathers(ctx) if ctx.prefetch else None

    def loss_fn(params, tele, batch, key, y):
        frames = batch["frames"].to(torch.bfloat16)
        tokens = batch["tokens"]
        B, Sd = tokens.shape
        Se = frames.shape[1]
        dev = frames.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        kt = _random.fold_in(key, 0)

        def run_stack(x, grp, L, key_fn, apply_fn):
            if ctx.prefetch:
                x, _ = _prefetch_layer_scan(
                    x, params[grp], metas[grp], ctx, y[grp], tele[grp], L,
                    split, key_fn, lambda xc, wts: (apply_fn(xc, wts), zero),
                    ctx.remat)
                return x

            def body(xc, i):
                wts = _gather_tree(_layer(params[grp], i), metas[grp], ctx,
                                   _layer(y[grp], i), key_fn(i),
                                   _layer(tele[grp], i), gathers)
                return apply_fn(xc, wts)

            for i in range(L):
                with torch.profiler.record_function(LAYER_SPAN):
                    x = (checkpoint(body, x, i, use_reentrant=False,
                                    preserve_rng_state=False) if ctx.remat
                         else body(x, i))
            return x

        # ---- encoder (bidirectional) ----
        pos_e = torch.arange(Se, dtype=torch.int32, device=dev)

        def enc_apply(xc, wts):
            a = LY.rms_norm(xc, wts["ln1"], cfg.norm_eps)
            att = LY.attention(a, wts, cfg, ctx, positions=pos_e,
                               causal=False)
            xc = xc + LY.attn_exit(att, cfg, ctx)
            m = LY.rms_norm(xc, wts["ln2"], cfg.norm_eps)
            return xc + psum_tp(LY.mlp(m, wts, cfg), ctx)

        x = run_stack(frames, "enc", cfg.enc_layers,
                      lambda i: _random.fold_in(key, i + 1), enc_apply)
        en = gather_param(params["top"]["enc_norm"],
                          metas["top"]["enc_norm"], ctx,
                          y["top"]["enc_norm"], _leaf_key(kt, "en"),
                          tele["top"]["enc_norm"], gathers)
        memory = LY.rms_norm(x, en, cfg.norm_eps)

        # ---- decoder ----
        emb = gather_param(params["top"]["embed"], metas["top"]["embed"], ctx,
                           y["top"]["embed"], _leaf_key(kt, "embed"),
                           tele["top"]["embed"], gathers)
        h = LY.vp_embed(tokens, emb, ctx)
        pos_d = torch.arange(Sd, dtype=torch.int32, device=dev)

        def dec_apply(hc, wts):
            a = LY.rms_norm(hc, wts["ln1"], cfg.norm_eps)
            att = LY.attention(a, wts, cfg, ctx, positions=pos_d,
                               causal=True)
            hc = hc + LY.attn_exit(att, cfg, ctx)
            c = LY.rms_norm(hc, wts["ln2"], cfg.norm_eps)
            # cross K/V from the memory (per-layer projections, replicated)
            mk = (memory @ wts["x_wk"]).reshape(B, Se, cfg.n_kv, cfg.head_dim)
            mv = (memory @ wts["x_wv"]).reshape(B, Se, cfg.n_kv, cfg.head_dim)
            xa = cross_attention(c, mk, mv, wts, cfg, ctx)
            hc = hc + LY.attn_exit(xa, cfg, ctx)
            m = LY.rms_norm(hc, wts["ln3"], cfg.norm_eps)
            return hc + psum_tp(LY.mlp(m, wts, cfg), ctx)

        h = run_stack(h, "dec", cfg.n_layers,
                      lambda i: _random.fold_in(key, 1000 + i), dec_apply)
        fn = gather_param(params["top"]["final_norm"],
                          metas["top"]["final_norm"], ctx,
                          y["top"]["final_norm"], _leaf_key(kt, "fn"),
                          tele["top"]["final_norm"], gathers)
        h = LY.rms_norm(h, fn, cfg.norm_eps)
        head = gather_param(params["top"]["lm_head"], metas["top"]["lm_head"],
                            ctx, y["top"]["lm_head"], _leaf_key(kt, "head"),
                            tele["top"]["lm_head"], gathers)
        mask = batch.get("mask")
        nll, cnt = LY.ce_sum(h.reshape(-1, cfg.d_model), head,
                             batch["targets"].reshape(-1), ctx,
                             None if mask is None else mask.reshape(-1))
        loss = nll / torch.clamp_min(cnt, 1.0)
        # the loss is replicated over tp: 1/tp makes each rank's gradient
        # exact (transformer.make_loss_fn)
        return loss / ctx.tp, {"loss": loss.detach()}

    return loss_fn
