"""Transformer layers; counterpart of ``repro.models.layers``.

Conventions, as the reference's: activations bf16, reductions and norms
in f32; weights arrive gathered (TP-local logical shapes, sharding.py);
attention shards query heads over tp and computes the replicated K/V
redundantly; with ``ctx.seq_parallel`` the residual stream is sharded over
tokens, and blocks all-gather tokens on entry and reduce-scatter partial
outputs on exit (Megatron-SP).  The TP collectives are sharding.py's
(their backward the reference's transposes); at tp = 1 each is the
identity.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (ShardCtx, _psum, all_gather_tp,
                                         pmax_tp, psum_tp, reduce_scatter_tp,
                                         tp_index)

ATTN_CHUNK = 512          # query-chunk length for memory-bounded attention


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin (..., head_dim/2) f32."""
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), expo)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, n, head_dim); cos/sin: (S, head_dim/2)."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def head_shards(cfg: ModelConfig, ctx: ShardCtx) -> int:
    """Distinct query-head shards: the largest power-of-two divisor of tp
    that divides n_heads."""
    g = 1
    k = 2
    while k <= ctx.tp:
        if ctx.tp % k == 0 and cfg.n_heads % k == 0:
            g = k
        k *= 2
    return g


def head_repl(cfg: ModelConfig, ctx: ShardCtx) -> int:
    """Replication factor of the attention weights across tp."""
    return ctx.tp // head_shards(cfg, ctx)


def local_heads(cfg: ModelConfig, ctx: ShardCtx) -> int:
    return cfg.n_heads // head_shards(cfg, ctx)


def _kv_map_local(cfg: ModelConfig, ctx: ShardCtx) -> torch.Tensor:
    """kv-head index for each local query head (GQA grouping)."""
    h_loc = local_heads(cfg, ctx)
    shard = tp_index(ctx) // head_repl(cfg, ctx)
    return (shard * h_loc + torch.arange(h_loc)) // cfg.q_per_kv


def _softmax_attend(q, k, v, mask, scale: float) -> torch.Tensor:
    """q: (B,Sq,h,d) k/v: (B,Sk,h,d) mask: (Sq,Sk) bool -> (B,Sq,h,d).
    Scores in f32 (the reference's preferred_element_type), probabilities
    cast to v's dtype for the second product."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _expand_kv(t: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx
               ) -> torch.Tensor:
    """(B,S,kv,hd) -> (B,S,h_loc,hd): local query head i reads kv head
    ``_kv_map_local[i]``.  The local heads are a contiguous run, so this is
    a broadcast of the kv heads they read, then a slice: its gradient is a
    plain sum, deterministic on the card."""
    B, S, _, hd = t.shape
    q = cfg.q_per_kv
    h_loc = local_heads(cfg, ctx)
    h0 = (tp_index(ctx) // head_repl(cfg, ctx)) * h_loc
    kv0, kv1 = h0 // q, (h0 + h_loc - 1) // q + 1
    e = t[:, :, kv0:kv1, None].expand(B, S, kv1 - kv0, q, hd) \
        .reshape(B, S, (kv1 - kv0) * q, hd)
    off = h0 - kv0 * q
    return e[:, :, off:off + h_loc]


def attention(xg: torch.Tensor, w: dict, cfg: ModelConfig, ctx: ShardCtx, *,
              positions: torch.Tensor, causal: bool = True, window: int = 0,
              kv_out: bool = False):
    """Training/prefill attention over gathered tokens.

    xg: (B, S, D); returns the partial output (B, S, D) of the local
    heads (the caller psums or reduce-scatters it).  S > ``ATTN_CHUNK`` runs
    query chunks of ``ATTN_CHUNK`` rows against every key, as the
    reference's scan does."""
    B, S, D = xg.shape
    hd = cfg.head_dim
    h_loc = local_heads(cfg, ctx)
    kv = cfg.n_kv

    q = (xg @ w["wq"]).reshape(B, S, h_loc, hd)
    k = (xg @ w["wk"]).reshape(B, S, kv, hd)
    v = (xg @ w["wv"]).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w["qn"], cfg.norm_eps)
        k = rms_norm(k, w["kn"], cfg.norm_eps)

    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_h = _expand_kv(k, cfg, ctx)
    v_h = _expand_kv(v, cfg, ctx)
    scale = float(1.0 / np.sqrt(hd))

    def mask_for(qpos):
        m = torch.ones((qpos.shape[0], S), dtype=torch.bool,
                       device=xg.device)
        if causal:
            m = qpos[:, None] >= positions[None, :]
        if window:
            m = m & ((qpos[:, None] - positions[None, :]) < window)
        return m

    if S <= ATTN_CHUNK:
        out = _softmax_attend(q, k_h, v_h, mask_for(positions), scale)
    else:
        C = ATTN_CHUNK
        outs = []
        for c0 in range(0, S, C):
            c1 = min(S, c0 + C)
            outs.append(_softmax_attend(q[:, c0:c1], k_h, v_h,
                                        mask_for(positions[c0:c1]), scale))
        out = torch.cat(outs, dim=1)

    out = out.reshape(B, S, h_loc * hd) @ w["wo"]
    if kv_out:
        return out, (k, v)
    return out


def mlp(xg: torch.Tensor, w: dict, cfg: ModelConfig) -> torch.Tensor:
    """Gathered-token MLP (swiglu, squared_relu, or tanh gelu, as
    ``jax.nn.gelu``'s default)."""
    if cfg.act == "swiglu":
        h = Fn.silu((xg @ w["wg"]).to(torch.float32))
        h = (h * (xg @ w["wu"]).to(torch.float32)).to(xg.dtype)
    elif cfg.act == "squared_relu":
        h = torch.relu((xg @ w["wi"]).to(torch.float32))
        h = (h * h).to(xg.dtype)
    else:
        h = Fn.gelu((xg @ w["wi"]).to(torch.float32),
                    approximate="tanh").to(xg.dtype)
    return h @ w["wd"]


# ---------------------------------------------------------------------------
# Sequence-parallel entry/exit
# ---------------------------------------------------------------------------

def sp_enter(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """(B, S/tp, D) -> (B, S, D)."""
    return all_gather_tp(x, ctx, axis=1) if ctx.seq_parallel else x


def sp_exit(partial_out: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """Partial (B, S, D) -> reduced (B, S/tp, D) [SP] or psum (B, S, D)."""
    if ctx.seq_parallel:
        return reduce_scatter_tp(partial_out, ctx, axis=1)
    return psum_tp(partial_out, ctx)


def token_slice(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """(B, S, D) -> this rank's (B, S/tp, D) token slice."""
    if ctx.tp == 1:
        return x
    s_loc = x.shape[1] // ctx.tp
    return x[:, tp_index(ctx) * s_loc:(tp_index(ctx) + 1) * s_loc]


def attn_exit(att: torch.Tensor, cfg: ModelConfig, ctx: ShardCtx
              ) -> torch.Tensor:
    """Exit for attention partials.  When heads are partially replicated
    (repl > 1), every replica contributes an identical copy of its shard's
    partial, so the psum / reduce-scatter over-counts by exactly repl:
    divide it back out."""
    repl = head_repl(cfg, ctx)
    out = sp_exit(att, ctx)
    if repl > 1:
        out = out / repl
    return out


# ---------------------------------------------------------------------------
# Embedding and cross-entropy
# ---------------------------------------------------------------------------

def vp_embed(tokens: torch.Tensor, emb: torch.Tensor, ctx: ShardCtx
             ) -> torch.Tensor:
    """tokens (B,S) int; emb (V/tp, D) local vocab slice -> (B,S,D)."""
    ok, safe = _target_cols(tokens.to(torch.int64), emb.shape[0], ctx)
    out = Fn.embedding(safe, emb)
    return psum_tp(torch.where(ok[..., None], out, torch.zeros_like(out)),
                   ctx)


def _target_cols(ids: torch.Tensor, v_loc: int, ctx: ShardCtx):
    """(ok, safe): whether each vocab id lies in this rank's ``v_loc``
    vocab rows, and its row there (clipped into range)."""
    local = ids - tp_index(ctx) * v_loc
    ok = (local >= 0) & (local < v_loc)
    return ok, local.clamp(0, v_loc - 1)


# rows of logits one block of the cross entropy holds
CE_ROWS = 1024


class _CESum(torch.autograd.Function):
    """Sum of masked nll of the vocab-parallel logits ``x @ head.T``
    (head: this rank's ``v_loc`` vocab rows), computed over blocks of
    ``CE_ROWS`` rows so that only one block's f32 logits exist at a time;
    the backward recomputes each block's logits.

    Per row, as the reference's ``_ce_sum``: m = pmax over TP of the local
    max (no gradient), z = psum of sum(exp(logits - m)), the target logit
    psummed from the one rank whose rows hold it, nll = log z + m - tgt.
    The padded vocab rows past V (the last rank's, when tp does not divide
    V) take part in m and z, as they do there.  The backward is the
    reference's transposes: the cotangent of z (g_nll / z) and of the
    target logit (-g_nll) are psummed over TP, then reach the logits
    through exp(logits - m) and the target's column."""

    @staticmethod
    def forward(fc, x, head, targets, mask, ctx: ShardCtx):
        hf = head.to(torch.float32)
        T_ = x.shape[0]
        ok, safe = _target_cols(targets, head.shape[0], ctx)
        m_all = torch.empty(T_, dtype=torch.float32, device=x.device)
        z_all = torch.empty(T_, dtype=torch.float32, device=x.device)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for r0 in range(0, T_, CE_ROWS):
            r1 = min(T_, r0 + CE_ROWS)
            logits = x[r0:r1].to(torch.float32) @ hf.T
            m = pmax_tp(torch.amax(logits, dim=-1), ctx)
            zed = torch.sum(torch.exp(logits - m[:, None]), dim=-1)
            tgt = torch.gather(logits, 1, safe[r0:r1, None])[:, 0]
            tgt = torch.where(ok[r0:r1], tgt, torch.zeros_like(tgt))
            if ctx.tp > 1:
                zed, tgt = _psum(torch.stack([zed, tgt]), ctx)
            nll = torch.log(zed) + m - tgt
            total = total + torch.sum(nll * mask[r0:r1])
            m_all[r0:r1], z_all[r0:r1] = m, zed
        fc.sctx = ctx
        fc.save_for_backward(x, head, targets, mask, m_all, z_all)
        return total

    @staticmethod
    def backward(fc, g):
        x, head, targets, mask, m_all, z_all = fc.saved_tensors
        ctx = fc.sctx
        hf = head.to(torch.float32)
        ok, safe = _target_cols(targets, head.shape[0], ctx)
        dx = torch.empty_like(x)
        dhead = torch.zeros_like(hf)
        for r0 in range(0, x.shape[0], CE_ROWS):
            r1 = min(x.shape[0], r0 + CE_ROWS)
            g_nll = g * mask[r0:r1]
            g_z, g_t = g_nll / z_all[r0:r1], -g_nll
            if ctx.tp > 1:
                g_z, g_t = _psum(torch.stack([g_z, g_t]), ctx)
            xf = x[r0:r1].to(torch.float32)
            logits = xf @ hf.T
            p = torch.exp(logits - m_all[r0:r1, None]) * g_z[:, None]
            rows = torch.arange(r1 - r0, device=x.device)
            p[rows, safe[r0:r1]] += torch.where(ok[r0:r1], g_t,
                                                torch.zeros_like(g_t))
            dx[r0:r1] = (p @ hf).to(x.dtype)
            dhead += p.T @ xf
        return dx, dhead.to(head.dtype), None, None, None


def ce_sum(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
           ctx: ShardCtx, mask: Optional[torch.Tensor]):
    """Vocab-parallel cross entropy of hidden rows ``x`` (T, D) against
    ``head`` (V/tp, D), this rank's vocab rows: (sum nll over the masked
    rows, token count), the same on every TP rank."""
    mf = (torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
          if mask is None else mask.to(torch.float32))
    nll = _CESum.apply(x, head, targets.to(torch.int64), mf, ctx)
    return nll, torch.sum(mf)


def vp_ce_loss(x: torch.Tensor, emb_out: torch.Tensor, targets: torch.Tensor,
               ctx: ShardCtx, mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Mean NLL over masked tokens of the vocab-parallel ``x @ emb_out.T``
    (replicated over tp)."""
    nll, cnt = ce_sum(x, emb_out, targets, ctx, mask)
    if mask is not None:
        return nll / torch.clamp_min(cnt, 1.0)
    return nll / x.shape[0]
