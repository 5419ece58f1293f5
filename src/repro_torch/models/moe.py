"""Expert-parallel MoE MLP (top-k router, capacity-bounded, all-to-all);
counterpart of ``repro.models.moe``.

Experts are sharded over the TP ranks (E_loc = E/tp per rank).  Each TP
rank routes a disjoint token slice (the sequence-parallel slice),
dispatches through the tiled TP all-to-all, computes its local experts and
returns the tokens with a second all-to-all.  The router weight is
TP-replicated (its gradient is psummed by the gather's backward).

Dispatch layout, as the reference's:
  disp  (E = tp*E_loc, C, D)  --a2a(split 0, concat 1)-->  (E_loc, tp*C, D)
  out   (E_loc, tp*C, D)      --a2a(split 1, concat 0)-->  (E, C, D)

Every kept (token, choice) pair owns one capacity slot; a dropped pair
points at its expert's last slot with a zero weight.  So the dispatch is
an index copy of the kept rows (no atomics; its backward a gather), and
the combine a gather whose accumulating backward adds to each slot its
pair's cotangent and the dropped pairs' exact zeros: the card and the CPU
give the same bits, and the same values as the reference's scatter-add.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as Fn

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx, all_to_all_tp


def capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, C: int):
    """The router of :func:`moe_mlp`: (gate (T, K) f32, idx (T, K), pos,
    keep (T*K,) bool, dest (T*K,), aux ()).  ``torch.topk`` promises no
    order among equal values; a stable descending sort takes the lower
    index first, as ``jax.lax.top_k`` does."""
    T = x.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = x.to(torch.float32) @ router.to(torch.float32)           # (T,E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = order.values[:, :K], order.indices[:, :K]             # (T,K)
    gate = gate / torch.clamp_min(torch.sum(gate, -1, keepdim=True), 1e-9)

    e_flat = idx.reshape(-1)                                          # (T*K,)
    onehot = Fn.one_hot(e_flat, E)
    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    ce = torch.sum(onehot, dim=0).to(torch.float32) / (T * K)
    aux = E * torch.sum(me * ce)
    # positions within each expert's capacity buffer
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=-1)
    keep = pos < C
    dest = e_flat * C + torch.clamp_max(pos, C - 1)
    return gate, idx, pos, keep, dest, aux


def _f32_bmm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(..., preferred_element_type=f32)``: the (exact) f32 casts
    of the operands, multiplied in f32."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def moe_mlp(x: torch.Tensor, w: dict, cfg: ModelConfig, ctx: ShardCtx):
    """x: (T, D) this rank's token slice.  Returns (out (T, D), aux ()).

    w: {"router": (D, E), "w1": (E_loc, D, F), "w3": (E_loc, D, F)
        [swiglu], "w2": (E_loc, F, D)}
    """
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)
    gate, _, _, keep, dest, aux = route(x, w["router"], cfg, C)

    x_rep = x[:, None].expand(T, K, D).reshape(T * K, D)            # (T*K,D)
    disp = x_rep.new_zeros((E * C, D)).index_copy(
        0, dest[keep], x_rep[keep]).reshape(E, C, D)
    recv = all_to_all_tp(disp, ctx, 0, 1)                    # (E_loc, tp*C, D)

    # expert FFN
    if cfg.act == "swiglu":
        h = Fn.silu(_f32_bmm("ecd,edf->ecf", recv, w["w1"]))
        h = (h * _f32_bmm("ecd,edf->ecf", recv, w["w3"])).to(x.dtype)
    else:
        h = Fn.gelu(_f32_bmm("ecd,edf->ecf", recv, w["w1"]),
                    approximate="tanh").to(x.dtype)
    eo = torch.einsum("ecf,efd->ecd", h, w["w2"])            # (E_loc, tp*C, D)
    back = all_to_all_tp(eo, ctx, 1, 0)                           # (E, C, D)

    flat = back.reshape(E * C, D)
    wgt = keep.to(x.dtype) * gate.reshape(-1).to(x.dtype)
    tok = flat[dest] * wgt[:, None]
    out = tok.reshape(T, K, D).sum(dim=1)
    return out, aux
