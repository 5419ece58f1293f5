"""Serving path: prefill and single-token decode with sharded KV caches;
counterpart of ``repro.models.serve``.

Decode cache sharding, as the reference's: the TP group is factored into
``g1`` KV-head groups x ``g2`` sequence shards (g1 = the largest
power-of-two divisor of tp that divides n_kv).  TP rank r = (i, j) holds

    cache[k|v]: (B_loc, n_kv/g1, S_max/g2, head_dim)

KV-head group i, sequence chunk j.  A decode step

  1. gathers its head group's query projection over its g2 subgroup
     (the weights stay in the training TP layout),
  2. attends its query group against its local sequence chunk,
  3. merges the partial softmax statistics by a max and a sum over the g2
     subgroup (the flash-decoding combine),
  4. projects out through its own ``wo`` shard and psums over the TP group.

Window attention (recurrentgemma's local blocks) keeps a replicated
ring-buffer cache with head-sharded queries.  The SSM and RG-LRU layers
carry O(1) recurrent state.

Where the reference returns new caches, the port writes the new K/V entry
(and its int8 scale) into the cache it is given, in place: a functional
copy would double the cache.  The recurrent states are new tensors each
step (f32 after the first step, as the reference's).  Every serving call
runs under ``torch.inference_mode()``; the subgroup collectives add their
members in rank order, so every rank of a group holds the same bits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch import random as _random
from repro_torch import resolve_device
from repro_torch.dist.fsdp import TELE_WIDTH
from repro_torch.models import encdec as ED
from repro_torch.models import layers as LY
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (ShardCtx, _psum, all_gather_group,
                                         all_gather_tp, gather_param,
                                         make_gathers, pmax_tp, psum_tp,
                                         tp_index)
from repro_torch.models.transformer import (_gather_tree, _layer, _leaf_key,
                                            _moe_apply, _sub, all_metas,
                                            n_scan_steps)

_F32 = torch.float32
# cache leaves a decode step updates in place (or only reads); the others
# (recurrent states) are new tensors each step
_IN_PLACE = ("k", "v", "k_scale", "v_scale", "wk", "wv", "xk", "xv")


def groups_of(cfg: ModelConfig, ctx: ShardCtx) -> "tuple[int, int]":
    g1 = cfg.kv_groups(ctx.tp)
    return g1, ctx.tp // g1


def seq_groups(cfg: ModelConfig, ctx: ShardCtx) -> "list[list[int]]":
    g1, g2 = groups_of(cfg, ctx)
    return [[i * g2 + j for j in range(g2)] for i in range(g1)]


# ---------------------------------------------------------------------------
# Cache shapes
# ---------------------------------------------------------------------------

def cache_struct(cfg: ModelConfig, ctx: ShardCtx, batch_local: int,
                 s_max: int, dtype=torch.bfloat16,
                 kv_quant: bool = False) -> dict:
    """Local (per-rank) cache shapes, the reference's.

    kv_quant: K/V stored as int8 with per-position f32 scales."""
    L = n_scan_steps(cfg)
    B = batch_local
    if cfg.family == "ssm":
        inner = cfg.ssm_expand * cfg.d_model // ctx.tp
        h_loc = inner // cfg.ssm_headdim
        return {
            "ssm": (L, B, h_loc, cfg.ssm_headdim, cfg.ssm_state),
            "conv_x": (L, B, cfg.conv_width - 1, inner),
            "conv_bc": (L, B, cfg.conv_width - 1, 2 * cfg.ssm_state),
        }
    if cfg.family == "hybrid":
        c_loc = (cfg.lru_width or cfg.d_model) // ctx.tp
        W = cfg.window
        d = {
            "lru1": (L, B, c_loc), "conv1": (L, B, cfg.conv_width - 1, c_loc),
            "lru2": (L, B, c_loc), "conv2": (L, B, cfg.conv_width - 1, c_loc),
            # the replicated ring-buffer window cache of the local attention
            "wk": (L, B, W, cfg.n_kv, cfg.head_dim),
            "wv": (L, B, W, cfg.n_kv, cfg.head_dim),
        }
        for t in range(cfg.n_layers % 3):          # unscanned tail layers
            d[f"tail{t}_lru"] = (B, c_loc)
            d[f"tail{t}_conv"] = (B, cfg.conv_width - 1, c_loc)
        return d
    g1, g2 = groups_of(cfg, ctx)
    kv_loc = cfg.n_kv // g1
    s_loc = -(-s_max // g2)
    shapes = {
        "k": (L, B, kv_loc, s_loc, cfg.head_dim),
        "v": (L, B, kv_loc, s_loc, cfg.head_dim),
    }
    if kv_quant:
        # per-position scales: an entry, once written, never changes
        shapes["k_scale"] = (L, B, kv_loc, s_loc)
        shapes["v_scale"] = (L, B, kv_loc, s_loc)
    if cfg.family == "encdec":
        shapes["xk"] = (cfg.n_layers, B, cfg.enc_seq, cfg.n_kv, cfg.head_dim)
        shapes["xv"] = (cfg.n_layers, B, cfg.enc_seq, cfg.n_kv, cfg.head_dim)
    return shapes


def cache_dtype(name: str, kv_quant: bool) -> torch.dtype:
    if kv_quant and name in ("k", "v"):
        return torch.int8
    if name.endswith("_scale"):
        return _F32
    return torch.bfloat16


def cache_zeros(cfg: ModelConfig, ctx: ShardCtx, batch_local: int,
                s_max: int, dtype=torch.bfloat16, kv_quant: bool = False,
                device=None) -> dict:
    """Zero caches of :func:`cache_struct`'s shapes on ``device`` (the CUDA
    device unless another is named)."""
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=cache_dtype(k, kv_quant), device=dev)
            for k, s in cache_struct(cfg, ctx, batch_local, s_max,
                                     kv_quant=kv_quant).items()}


# ---------------------------------------------------------------------------
# Decode attention (full context, 2-D sharded cache)
# ---------------------------------------------------------------------------

def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by IEEE division of f32 ``c``: a Python-scalar divisor
    becomes a reciprocal multiply on the card, a 0-d tensor does not."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _quantize_kv(t: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """The reference's int8 entry of new K/V rows ``t`` (..., hd): (int8
    rows, f32 per-row absmax scale); the row dequantizes as
    ``q * scale / 127``."""
    tf = t.to(_F32)
    s = torch.amax(torch.abs(tf), dim=-1)
    q = torch.round(tf / torch.clamp_min(s, 1e-9)[..., None] * 127.0)
    return torch.clamp(q, -127, 127).to(torch.int8), s


def decode_attention(x: torch.Tensor, wts: dict, ck: torch.Tensor,
                     cv: torch.Tensor, pos, cfg: ModelConfig, ctx: ShardCtx,
                     kscale: Optional[torch.Tensor] = None,
                     vscale: Optional[torch.Tensor] = None):
    """x: (B, D) one token a sequence; ck/cv: (B, kv_loc, S_loc, hd).

    With kscale/vscale (B, kv_loc, S_loc) given, ck/cv are int8 and are
    dequantized on the fly (absmax/127 per (batch, KV head, position); the
    scales fold into the logits and the probabilities after the products).
    The new entry at ``pos`` is written into the given tensors in place, by
    the rank of the g2 group that owns it.  Returns (out (B, D) partial over
    TP, ck, cv[, kscale, vscale])."""
    B, D = x.shape
    hd = cfg.head_dim
    g1, g2 = groups_of(cfg, ctx)
    kv_loc = cfg.n_kv // g1
    hg = cfg.n_heads // g1                       # query heads in my group
    h_loc = LY.local_heads(cfg, ctx)
    repl = LY.head_repl(cfg, ctx)
    shards = LY.head_shards(cfg, ctx)
    if shards % g1:
        raise ValueError(f"{shards} head shards do not split into {g1} "
                         f"KV-head groups")
    s_loc = ck.shape[2]
    pos = int(pos)
    r = tp_index(ctx)
    i, j = r // g2, r % g2
    sg = seq_groups(cfg, ctx)

    # -- the group's query projection: gather wq over the seq subgroup --
    if h_loc == hg:
        wq_g = wts["wq"]                          # my shard covers the group
    else:
        wq_g = all_gather_group(wts["wq"], ctx, sg, axis=1)
        if repl > 1:
            # replicated shards come in runs of repl: keep every repl-th
            wq_g = wq_g.reshape(D, g2, h_loc * hd)[:, ::repl].reshape(
                D, hg * hd)
    q = (x @ wq_g).reshape(B, hg, hd)

    # -- the new K/V of my KV group (wk/wv replicated; slice group i) --
    k_new = (x @ wts["wk"]).reshape(B, cfg.n_kv, hd)[
        :, i * kv_loc:(i + 1) * kv_loc]
    v_new = (x @ wts["wv"]).reshape(B, cfg.n_kv, hd)[
        :, i * kv_loc:(i + 1) * kv_loc]
    if cfg.qk_norm:
        q = LY.rms_norm(q, wts["qn"], cfg.norm_eps)
        k_new = LY.rms_norm(k_new, wts["kn"], cfg.norm_eps)
    cos, sin = LY.rope_angles(torch.tensor([pos], device=x.device), hd,
                              cfg.rope_theta)                  # (1, hd/2)
    q = LY.apply_rope(q[:, None], cos, sin)[:, 0]
    k_new = LY.apply_rope(k_new[:, None], cos, sin)[:, 0]

    # -- write into my sequence chunk if I own position pos --
    quant = kscale is not None
    local_pos = pos % s_loc
    if g2 == 1 or pos // s_loc == j:
        if quant:
            k_w, kscale[:, :, local_pos] = _quantize_kv(k_new)
            v_w, vscale[:, :, local_pos] = _quantize_kv(v_new)
        else:
            k_w, v_w = k_new, v_new
        ck[:, :, local_pos] = k_w
        cv[:, :, local_pos] = v_w

    # -- partial attention over my chunk, one product per KV head: both
    # products take bf16 operands into f32 (their exact f32 casts) --
    qpk = hg // max(kv_loc, 1)
    q4 = q.reshape(B, kv_loc, qpk, hd).to(torch.bfloat16).to(_F32)
    logits = _div(torch.einsum("bkqd,bksd->bkqs", q4, ck.to(_F32)),
                  float(np.sqrt(hd)))
    if quant:
        logits = logits * _div(kscale, 127.0)[:, :, None, :]
    gpos = (j * s_loc if g2 > 1 else 0) + torch.arange(s_loc,
                                                       device=x.device)
    logits = logits.masked_fill((gpos > pos)[None, None, None], -1e30)

    m_loc = torch.amax(logits, dim=-1)           # (B, kv_loc, qpk)
    m = pmax_tp(m_loc, ctx, sg) if g2 > 1 else m_loc
    p = torch.exp(logits - m[..., None])
    l_loc = torch.sum(p, dim=-1)
    if quant:
        p = p * _div(vscale, 127.0)[:, :, None, :]   # v scales into probs
    o_loc = torch.einsum("bkqs,bksd->bkqd",
                         p.to(torch.bfloat16).to(_F32), cv.to(_F32))
    if g2 > 1:
        # one grouped sum of (o, l): each element is its own sum
        lo = _psum(torch.cat([o_loc, l_loc[..., None]], dim=-1), ctx, sg)
        o, l = lo[..., :hd], lo[..., hd]
    else:
        o, l = o_loc, l_loc
    out_g = (o / torch.clamp_min(l, 1e-30)[..., None]).to(x.dtype)
    out_g = out_g.reshape(B, hg, hd)

    # -- my wo shard covers my h_loc heads: my shard's place in the group --
    if h_loc < hg:
        off = (r // repl) * h_loc - i * hg
        out_g = out_g[:, off:off + h_loc]
    out = out_g.reshape(B, h_loc * hd) @ wts["wo"]    # partial over tp
    if quant:
        return out, ck, cv, kscale, vscale
    return out, ck, cv


def window_decode_attention(x: torch.Tensor, wts: dict, ck: torch.Tensor,
                            cv: torch.Tensor, pos, cfg: ModelConfig,
                            ctx: ShardCtx):
    """The ring-buffer window cache, replicated over TP, heads sharded.

    ck/cv: (B, W, n_kv, hd), written in place at slot ``pos mod W``.
    Returns (out partial, ck, cv)."""
    B, D = x.shape
    hd = cfg.head_dim
    W = ck.shape[1]
    h_loc = LY.local_heads(cfg, ctx)
    pos = int(pos)

    q = (x @ wts["wq"]).reshape(B, h_loc, hd)
    k_new = (x @ wts["wk"]).reshape(B, cfg.n_kv, hd)
    v_new = (x @ wts["wv"]).reshape(B, cfg.n_kv, hd)
    cos, sin = LY.rope_angles(torch.tensor([pos], device=x.device), hd,
                              cfg.rope_theta)
    q = LY.apply_rope(q[:, None], cos, sin)[:, 0]
    k_new = LY.apply_rope(k_new[:, None], cos, sin)[:, 0]

    slot = pos % W
    ck[:, slot] = k_new
    cv[:, slot] = v_new
    kv_map = LY._kv_map_local(cfg, ctx).to(x.device)
    k_h = ck.index_select(2, kv_map)             # (B, W, h_loc, hd)
    v_h = cv.index_select(2, kv_map)
    logits = _div(torch.einsum("bhd,bwhd->bhw", q.to(_F32), k_h.to(_F32)),
                  float(np.sqrt(hd)))
    # ring-buffer validity: slot w holds position pos - ((slot - w) mod W)
    p_w = pos - torch.remainder(slot - torch.arange(W, device=x.device), W)
    valid = (p_w >= 0) & (p_w <= pos) & (pos - p_w < cfg.window)
    probs = torch.softmax(logits.masked_fill(~valid[None, None], -1e30),
                          dim=-1)
    o = torch.einsum("bhw,bwhd->bhd", probs, v_h.to(_F32))
    out = o.to(x.dtype).reshape(B, h_loc * hd) @ wts["wo"]
    return out, ck, cv


# ---------------------------------------------------------------------------
# serve_step builders
# ---------------------------------------------------------------------------

def _moe_decode(x: torch.Tensor, wts: dict, cfg: ModelConfig,
                ctx: ShardCtx) -> torch.Tensor:
    """The MoE for (B, D) decode tokens: pad the tokens to a multiple of
    tp, route this rank's slice, gather the slices back."""
    B, D = x.shape
    if ctx.tp == 1:
        out, _ = MOE.moe_mlp(x, wts, cfg, ctx)
        return out
    Bp = -(-B // ctx.tp) * ctx.tp
    t_loc = Bp // ctx.tp
    r = tp_index(ctx)
    sl = Fn.pad(x, (0, 0, 0, Bp - B))[r * t_loc:(r + 1) * t_loc]
    out, _ = MOE.moe_mlp(sl, wts, cfg, ctx)
    return all_gather_tp(out, ctx, axis=0)[:B]


def _greedy(x: torch.Tensor, head: torch.Tensor, ctx: ShardCtx
            ) -> torch.Tensor:
    """Vocab-parallel greedy sampling of the next token from the hidden
    rows ``x`` (B, D) and this rank's ``head`` rows (V/tp, D): the first
    maximal logit within a rank; across ranks, on an exact tie, the larger
    id."""
    logits = x.to(_F32) @ head.to(_F32).T                     # (B, V/tp)
    loc_max = torch.amax(logits, dim=-1)
    loc_arg = torch.argmax(logits, dim=-1) + tp_index(ctx) * head.shape[0]
    if ctx.tp > 1:
        gmax = pmax_tp(loc_max, ctx)
        cand = torch.where(loc_max >= gmax, loc_arg, torch.zeros_like(loc_arg))
        return pmax_tp(cand, ctx).to(torch.int32)
    return loc_arg.to(torch.int32)


def _serving_leaves(device):
    """(y, tele) of a serving gather: a unit distance bound and zero
    telemetry, neither requiring grad (no backward runs)."""
    return (torch.ones((), dtype=_F32, device=device),
            torch.zeros((TELE_WIDTH,), dtype=_F32, device=device))


def _gather_top(params: dict, metas: dict, ctx: ShardCtx, name: str, key,
                tag: str, gathers, device) -> torch.Tensor:
    y, tz = _serving_leaves(device)
    return gather_param(params["top"][name], metas["top"][name], ctx, y,
                        _leaf_key(key, tag), tz, gathers)


def _gather_layer(lp: dict, metas: dict, ctx: ShardCtx, key, gathers,
                  device) -> dict:
    y, tz = _serving_leaves(device)
    return _gather_tree(lp, metas, ctx, {k: y for k in metas}, key,
                        {k: tz for k in metas}, gathers)


def _stack_steps(cache: dict, per_layer: "list[dict]") -> dict:
    """The cache after a layer loop: the in-place leaves as they are, the
    recurrent states stacked from each layer's new state."""
    out = dict(cache)
    for k in per_layer[0] if per_layer else ():
        out[k] = torch.stack([nc[k] for nc in per_layer])
    return out


def make_encdec_serve_step(cfg: ModelConfig, ctx: ShardCtx):
    """The whisper-style decoder step: self-attention decode, then
    cross-attention against the encoder K/V cache (xk/xv, built once per
    audio segment by the prefill).  cache: {"k", "v" (L, B, kv_loc, S_loc,
    hd), "xk", "xv" (L, B, Se, KV, hd)}."""
    metas = ED.encdec_metas(cfg, ctx)
    gathers = make_gathers(ctx)
    L = cfg.n_layers

    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos, key):
        dev = tokens.device
        kt = _random.fold_in(key, 0)
        emb = _gather_top(params, metas, ctx, "embed", kt, "embed", gathers,
                          dev)
        x = LY.vp_embed(tokens[:, 0], emb, ctx)
        repl = LY.head_repl(cfg, ctx)
        for l in range(L):
            lc = _layer(cache, l)
            wts = _gather_layer(_layer(params["dec"], l), metas["dec"], ctx,
                                _random.fold_in(key, l + 1), gathers, dev)
            a = LY.rms_norm(x, wts["ln1"], cfg.norm_eps)
            att, _, _ = decode_attention(a, wts, lc["k"], lc["v"], pos, cfg,
                                         ctx)
            x = x + psum_tp(att, ctx) / repl
            c = LY.rms_norm(x, wts["ln2"], cfg.norm_eps)
            xa = ED.cross_attention(c[:, None], lc["xk"], lc["xv"], wts, cfg,
                                    ctx)[:, 0]
            x = x + psum_tp(xa, ctx) / repl
            m = LY.rms_norm(x, wts["ln3"], cfg.norm_eps)
            x = x + psum_tp(LY.mlp(m[:, None], wts, cfg)[:, 0], ctx)
        fn = _gather_top(params, metas, ctx, "final_norm", kt, "fn", gathers,
                         dev)
        x = LY.rms_norm(x, fn, cfg.norm_eps)
        head = _gather_top(params, metas, ctx, "lm_head", kt, "head",
                           gathers, dev)
        return _greedy(x, head, ctx), dict(cache)

    return serve_step


def make_serve_step(cfg: ModelConfig, ctx: ShardCtx, kv_quant: bool = False):
    """Returns serve_step(params, cache, tokens (B, 1), pos, key) ->
    (next_token (B,) int32, cache).  ``params`` are this rank's storage
    slices (bf16 for serving), ``pos`` an int.  The K/V (and window) leaves
    of ``cache`` are updated in place and returned; the recurrent states
    come back as new tensors."""
    if cfg.family == "encdec":
        return make_encdec_serve_step(cfg, ctx)
    metas = all_metas(cfg, ctx)
    gathers = make_gathers(ctx)
    L = n_scan_steps(cfg)

    def body(x, wts, lc, pos):
        """One scanned layer; returns (x, the layer's new states)."""
        if cfg.family == "ssm":
            a = LY.rms_norm(x, wts["ln1"], cfg.norm_eps)
            out, ns = SSM.mamba2_block(a[:, None], wts, cfg, ctx, state=lc)
            return x + psum_tp(out[:, 0], ctx), ns
        if cfg.family == "hybrid":
            x, nc = _hybrid_decode_unit(x, wts, lc, pos, cfg, ctx)
            return x, {k: v for k, v in nc.items() if k not in _IN_PLACE}
        a = LY.rms_norm(x, wts["ln1"], cfg.norm_eps)
        if kv_quant:
            att = decode_attention(a, wts, lc["k"], lc["v"], pos, cfg, ctx,
                                   kscale=lc["k_scale"],
                                   vscale=lc["v_scale"])[0]
        else:
            att = decode_attention(a, wts, lc["k"], lc["v"], pos, cfg,
                                   ctx)[0]
        x = x + psum_tp(att, ctx) / LY.head_repl(cfg, ctx)
        m = LY.rms_norm(x, wts["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            return x + _moe_decode(m, wts, cfg, ctx), {}
        return x + psum_tp(LY.mlp(m[:, None], wts, cfg)[:, 0], ctx), {}

    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos, key):
        dev = tokens.device
        kt = _random.fold_in(key, 0)
        emb = _gather_top(params, metas, ctx, "embed", kt, "embed", gathers,
                          dev)
        x = LY.vp_embed(tokens[:, 0], emb, ctx) * cfg.emb_scale    # (B, D)
        scanned = {k: v for k, v in cache.items() if not k.startswith("tail")}
        states = []
        for l in range(L):
            wts = _gather_layer(_layer(params["layers"], l), metas["layers"],
                                ctx, _random.fold_in(key, l + 1), gathers,
                                dev)
            x, ns = body(x, wts, _layer(scanned, l), pos)
            states.append(ns)
        new_cache = _stack_steps(cache, states)

        # the hybrid's unscanned tail recurrent layers
        if cfg.family == "hybrid":
            for t in range(cfg.n_layers % 3):
                p = f"tail{t}_"
                names = [k for k in metas["top"] if k.startswith(p)]
                sw = _sub(_gather_layer(
                    {k: params["top"][k] for k in names},
                    {k: metas["top"][k] for k in names}, ctx,
                    _random.fold_in(key, 10_000 + t), gathers, dev), p)
                a = LY.rms_norm(x, sw["ln1"], cfg.norm_eps)
                st = {"lru": cache[f"{p}lru"], "conv": cache[f"{p}conv"]}
                out, ns = RG.recurrent_block(a[:, None], sw, cfg, ctx,
                                             state=st)
                x = x + psum_tp(out[:, 0], ctx)
                new_cache[f"{p}lru"] = ns["lru"]
                new_cache[f"{p}conv"] = ns["conv"]
                m = LY.rms_norm(x, sw["ln2"], cfg.norm_eps)
                x = x + psum_tp(LY.mlp(m[:, None], sw, cfg)[:, 0], ctx)

        fn = _gather_top(params, metas, ctx, "final_norm", kt, "fn", gathers,
                         dev)
        x = LY.rms_norm(x, fn, cfg.norm_eps)
        head = emb if cfg.tie_embeddings else _gather_top(
            params, metas, ctx, "lm_head", kt, "head", gathers, dev)
        return _greedy(x, head, ctx), new_cache

    return serve_step


def _hybrid_decode_unit(x: torch.Tensor, wts: dict, lc: dict, pos,
                        cfg: ModelConfig, ctx: ShardCtx):
    nc = dict(lc)
    for n, p in ((1, "r1_"), (2, "r2_")):
        sw = _sub(wts, p)
        a = LY.rms_norm(x, sw["ln1"], cfg.norm_eps)
        st = {"lru": lc[f"lru{n}"], "conv": lc[f"conv{n}"]}
        out, ns = RG.recurrent_block(a[:, None], sw, cfg, ctx, state=st)
        x = x + psum_tp(out[:, 0], ctx)
        nc[f"lru{n}"], nc[f"conv{n}"] = ns["lru"], ns["conv"]
        m = LY.rms_norm(x, sw["ln2"], cfg.norm_eps)
        x = x + psum_tp(LY.mlp(m[:, None], sw, cfg)[:, 0], ctx)
    sw = _sub(wts, "at_")
    a = LY.rms_norm(x, sw["ln1"], cfg.norm_eps)
    att, nc["wk"], nc["wv"] = window_decode_attention(a, sw, lc["wk"],
                                                      lc["wv"], pos, cfg, ctx)
    x = x + psum_tp(att, ctx) / LY.head_repl(cfg, ctx)
    m = LY.rms_norm(x, sw["ln2"], cfg.norm_eps)
    x = x + psum_tp(LY.mlp(m[:, None], sw, cfg)[:, 0], ctx)
    return x, nc


# ---------------------------------------------------------------------------
# Prefill: the forward pass writing the cache
# ---------------------------------------------------------------------------

def _decode_layout(k: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx
                   ) -> torch.Tensor:
    """Prefill K or V (B, S, KV, hd) -> this rank's decode-layout slice
    (B, kv_loc, ceil(S/g2), hd): its KV group, its chunk of the sequence
    (the sequence zero-padded to g2 chunks)."""
    g1, g2 = groups_of(cfg, ctx)
    S = k.shape[1]
    r = tp_index(ctx)
    i, j = r // g2, r % g2
    kv_loc = max(cfg.n_kv // g1, 1)
    s_loc = -(-S // g2)
    kk = k.transpose(1, 2)[:, i * kv_loc:(i + 1) * kv_loc]
    if g2 > 1:
        kk = Fn.pad(kk, (0, 0, 0, g2 * s_loc - S))[:, :, j * s_loc:
                                                   (j + 1) * s_loc]
    return kk.to(torch.bfloat16)


def make_prefill(cfg: ModelConfig, ctx: ShardCtx):
    """prefill(params, tokens (B, S), key, img=None) -> (last hidden
    (B, D), cache).

    The training forward (head-sharded attention), the computed K/V
    re-sharded into the decode layout (KV group x sequence chunk of the
    prompt).  As the reference's: the dense attention's partial outputs
    are psummed without dividing by ``head_repl``, and the hybrid's
    unscanned tail layers do not run."""
    metas = all_metas(cfg, ctx)
    gathers = make_gathers(ctx)
    L = n_scan_steps(cfg)
    Wc = cfg.conv_width - 1

    def body(x, wts, positions, S):
        """One scanned layer over the prompt -> (x, its cache piece)."""
        if cfg.family == "ssm":
            a = LY.rms_norm(x, wts["ln1"], cfg.norm_eps)
            out, ns = SSM.mamba2_block(a, wts, cfg, ctx)
            x = x + psum_tp(out, ctx)
            return x, {"ssm": ns["ssm"].to(torch.bfloat16),
                       "conv_x": (a @ wts["wx"])[:, -Wc:].to(torch.bfloat16),
                       "conv_bc": (a @ wts["wbc"])[:, -Wc:].to(
                           torch.bfloat16)}
        if cfg.family == "hybrid":
            piece = {}
            for n, p in ((1, "r1_"), (2, "r2_")):
                sw = _sub(wts, p)
                a = LY.rms_norm(x, sw["ln1"], cfg.norm_eps)
                out, ns = RG.recurrent_block(a, sw, cfg, ctx)
                x = x + psum_tp(out, ctx)
                piece[f"lru{n}"] = ns["lru"].to(torch.bfloat16)
                piece[f"conv{n}"] = (a @ sw["wx"])[:, -Wc:].to(torch.bfloat16)
                m = LY.rms_norm(x, sw["ln2"], cfg.norm_eps)
                x = x + psum_tp(LY.mlp(m, sw, cfg), ctx)
            sw = _sub(wts, "at_")
            a = LY.rms_norm(x, sw["ln1"], cfg.norm_eps)
            att, (k, v) = LY.attention(a, sw, cfg, ctx, positions=positions,
                                       causal=True, window=cfg.window,
                                       kv_out=True)
            x = x + LY.attn_exit(att, cfg, ctx)
            m = LY.rms_norm(x, sw["ln2"], cfg.norm_eps)
            x = x + psum_tp(LY.mlp(m, sw, cfg), ctx)
            # the ring buffer: the last W positions, position p in slot
            # p mod W (left-padded when S < W, then rolled by S mod W)
            Wn = cfg.window
            for name, t in (("wk", k), ("wv", v)):
                t = t[:, -Wn:] if S >= Wn else Fn.pad(
                    t, (0, 0, 0, 0, Wn - S, 0))
                piece[name] = torch.roll(t, S % Wn, dims=1).to(
                    torch.bfloat16)
            return x, piece
        a = LY.rms_norm(x, wts["ln1"], cfg.norm_eps)
        att, (k, v) = LY.attention(a, wts, cfg, ctx, positions=positions,
                                   causal=True, kv_out=True)
        x = x + psum_tp(att, ctx)
        m = LY.rms_norm(x, wts["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            x = x + _moe_apply(m, wts, cfg, ctx)[0]
        else:
            x = x + psum_tp(LY.mlp(m, wts, cfg), ctx)
        return x, {"k": _decode_layout(k, cfg, ctx),
                   "v": _decode_layout(v, cfg, ctx)}

    @torch.inference_mode()
    def prefill(params, tokens, key, img=None):
        dev = tokens.device
        kt = _random.fold_in(key, 0)
        emb = _gather_top(params, metas, ctx, "embed", kt, "embed", gathers,
                          dev)
        x = LY.vp_embed(tokens, emb, ctx) * cfg.emb_scale
        if img is not None:                      # vlm: patch embeds prefix
            x = torch.cat([img.to(x.dtype), x], dim=1)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=dev)
        pieces = []
        for l in range(L):
            wts = _gather_layer(_layer(params["layers"], l), metas["layers"],
                                ctx, _random.fold_in(key, l + 1), gathers,
                                dev)
            x, piece = body(x, wts, positions, S)
            pieces.append(piece)
        fn = _gather_top(params, metas, ctx, "final_norm", kt, "fn", gathers,
                         dev)
        return (LY.rms_norm(x[:, -1], fn, cfg.norm_eps),
                _stack_steps({}, pieces))

    return prefill


def make_encdec_prefill(cfg: ModelConfig, ctx: ShardCtx):
    """Whisper prefill: the encoder over the (stub) frames, each decoder
    layer's cross K/V cache, and the decoder's self-attention cache over
    the prompt tokens."""
    metas = ED.encdec_metas(cfg, ctx)
    gathers = make_gathers(ctx)

    @torch.inference_mode()
    def prefill(params, frames, tokens, key):
        dev = tokens.device
        B, S = tokens.shape
        Se = frames.shape[1]
        kt = _random.fold_in(key, 0)
        x = frames.to(torch.bfloat16)
        pos_e = torch.arange(Se, dtype=torch.int32, device=dev)
        for l in range(cfg.enc_layers):
            wts = _gather_layer(_layer(params["enc"], l), metas["enc"], ctx,
                                _random.fold_in(key, l + 1), gathers, dev)
            a = LY.rms_norm(x, wts["ln1"], cfg.norm_eps)
            att = LY.attention(a, wts, cfg, ctx, positions=pos_e,
                               causal=False)
            x = x + LY.attn_exit(att, cfg, ctx)
            m = LY.rms_norm(x, wts["ln2"], cfg.norm_eps)
            x = x + psum_tp(LY.mlp(m, wts, cfg), ctx)
        en = _gather_top(params, metas, ctx, "enc_norm", kt, "en", gathers,
                         dev)
        memory = LY.rms_norm(x, en, cfg.norm_eps)

        emb = _gather_top(params, metas, ctx, "embed", kt, "embed", gathers,
                          dev)
        h = LY.vp_embed(tokens, emb, ctx)
        pos_d = torch.arange(S, dtype=torch.int32, device=dev)
        pieces = []
        for l in range(cfg.n_layers):
            wts = _gather_layer(_layer(params["dec"], l), metas["dec"], ctx,
                                _random.fold_in(key, 1000 + l), gathers, dev)
            a = LY.rms_norm(h, wts["ln1"], cfg.norm_eps)
            att, (k, v) = LY.attention(a, wts, cfg, ctx, positions=pos_d,
                                       causal=True, kv_out=True)
            h = h + LY.attn_exit(att, cfg, ctx)
            c = LY.rms_norm(h, wts["ln2"], cfg.norm_eps)
            mk = (memory @ wts["x_wk"]).reshape(B, Se, cfg.n_kv, cfg.head_dim)
            mv = (memory @ wts["x_wv"]).reshape(B, Se, cfg.n_kv, cfg.head_dim)
            h = h + LY.attn_exit(ED.cross_attention(c, mk, mv, wts, cfg, ctx),
                                 cfg, ctx)
            m = LY.rms_norm(h, wts["ln3"], cfg.norm_eps)
            h = h + psum_tp(LY.mlp(m, wts, cfg), ctx)
            pieces.append({"k": _decode_layout(k, cfg, ctx),
                           "v": _decode_layout(v, cfg, ctx),
                           "xk": mk.to(torch.bfloat16),
                           "xv": mv.to(torch.bfloat16)})
        fn = _gather_top(params, metas, ctx, "final_norm", kt, "fn", gathers,
                         dev)
        return (LY.rms_norm(h[:, -1], fn, cfg.norm_eps),
                _stack_steps({}, pieces))

    return prefill
