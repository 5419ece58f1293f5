"""RG-LRU recurrent block (RecurrentGemma / Griffin); counterpart of
``repro.models.rglru``.

The RG-LRU recurrence (per channel c):
    r_t = sigmoid(w_r * x_t + b_r)            (recurrence gate, diagonal)
    i_t = sigmoid(w_i * x_t + b_i)            (input gate, diagonal)
    log a_t = -c0 * softplus(lambda) * r_t    (c0 = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

computed by a parallel prefix over the sequence: :func:`associative_scan`
follows ``jax.lax.associative_scan``'s odd/even recursion, so its
products are formed in the reference's order, in about 2 log2(S) steps of
whole-tensor operations rather than S steps.  Channels are sharded over
TP; the gates are diagonal (channel-local), the reference's documented
simplification of RecurrentGemma's block-diagonal gates.

The hybrid block pattern (2 recurrent : 1 local attention) is assembled in
``models/transformer.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as Fn

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx
from repro_torch.models.ssm import _dw_conv, softplus

C0 = 8.0


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``axis`` (len(a) is len(b) or one
    more)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[axis] = slice(0, n, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, n, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(fn: Callable, elems: tuple, axis: int = 0) -> tuple:
    """Inclusive scan of ``fn`` (associative; ``fn(earlier, later)``) over
    a tuple of tensors along ``axis``: ``jax.lax.associative_scan``'s
    recursion (combine adjacent pairs, scan the pairs, fill in the evens)."""
    def sl(t, start, stop, step=1):
        idx = [slice(None)] * t.dim()
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    def scan(el):
        n = el[0].shape[axis]
        if n < 2:
            return el
        reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in el),
                     tuple(sl(e, 1, None, 2) for e in el))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(sl(e, 0, e.shape[axis] - 1) for e in odd),
                      tuple(sl(e, 2, None, 2) for e in el))
        else:
            even = fn(odd, tuple(sl(e, 2, None, 2) for e in el))
        even = tuple(torch.cat([sl(e, 0, 1), r], dim=axis)
                     for e, r in zip(el, even))
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    return scan(tuple(elems))


def _combine(u, v):
    a1, b1 = u
    a2, b2 = v
    return a1 * a2, a2 * b1 + b2


def rg_lru(x: torch.Tensor, wts: dict, state: Optional[torch.Tensor] = None):
    """x: (B, S, C_loc).  state: (B, C_loc) hidden.  Returns (y, new_state).

    wts: {"w_r", "b_r", "w_i", "b_i", "lam": (C_loc,)}
    """
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf * wts["w_r"] + wts["b_r"])
    i = torch.sigmoid(xf * wts["w_i"] + wts["b_i"])
    log_a = -C0 * softplus(wts["lam"]) * r                         # (B,S,C)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i * xf)

    if state is not None and x.shape[1] == 1:
        h = a[:, 0] * state + gated[:, 0]
        return h.to(x.dtype)[:, None], h

    if state is not None:
        gated = torch.cat([gated[:, :1] + a[:, :1] * state[:, None],
                           gated[:, 1:]], dim=1)
    _, hh = associative_scan(_combine, (a, gated), axis=1)
    return hh.to(x.dtype), hh[:, -1]


def recurrent_block(x: torch.Tensor, wts: dict, cfg: ModelConfig,
                    ctx: ShardCtx, state: Optional[dict] = None):
    """Griffin recurrent block.  x: (B, S, D) -> (partial out (B, S, D),
    state).

    wts: {"wy": (D, C_loc), "wx": (D, C_loc), "conv": (W, C_loc),
          gates..., "wo": (C_loc, D)}
    state: {"lru": (B, C_loc), "conv": (B, W-1, C_loc)}
    """
    ybr = Fn.gelu((x @ wts["wy"]).to(torch.float32),
                  approximate="tanh").to(x.dtype)
    xbr = x @ wts["wx"]
    if state is not None and x.shape[1] == 1:
        xbr, conv_cache = _dw_conv(xbr, wts["conv"], state["conv"])
        h, lru_state = rg_lru(xbr, wts, state["lru"])
        new_state = {"lru": lru_state, "conv": conv_cache}
    else:
        xbr, _ = _dw_conv(xbr, wts["conv"])
        init = state["lru"] if state is not None else None
        h, lru_state = rg_lru(xbr, wts, init)
        new_state = {"lru": lru_state, "conv": None}
    out = (h * ybr) @ wts["wo"]                            # partial over tp
    return out, new_state
