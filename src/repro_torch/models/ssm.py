"""Mamba-2 SSD (state-space duality) layer, chunked training/prefill and
the one-token step; counterpart of ``repro.models.ssm``.

The minimal SSD algorithm (Mamba-2 paper, Listing 1) under manual TP, as
the reference's: heads and the inner dim are sharded over TP; the shared
B/C projections (ngroups = 1) are TP-replicated; the gated RMSNorm over
the sharded inner dim psums its sum of squares over TP.

The reference's three-operand einsums are contracted pairwise here, in an
order that never builds a (b, c, h, q, k, p) tensor: the intra-chunk
product forms G * L, (b, c, h, q, k), then one batched matmul with the
inputs.  The inter-chunk ``lax.scan`` is a loop over the chunks.

Shapes (per rank): inner = expand*D / tp channels, H_loc = inner/headdim
heads, state N = cfg.ssm_state, chunk Q = cfg.ssm_chunk.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn

from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx, psum_tp

_F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's softplus returns x
    itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., q) -> (..., q, q) lower-tri segment sums:
    S[i, j] = sum_{j<k<=i} a_k (-inf above the diagonal)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return s.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """SSD over a full sequence.

    xh: (B, S, H, P) per-head inputs; dt: (B, S, H) positive step sizes;
    A: (H,) negative decay rates (A = -exp(A_log)); Bm, Cm: (B, S, N)
    shared input and output maps (ngroups = 1).
    Returns (y (B, S, H, P) in xh's dtype, final_state (B, H, P, N) f32).
    """
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        xh = Fn.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = Fn.pad(dt, (0, 0, 0, pad))
        Bm = Fn.pad(Bm, (0, 0, 0, pad))
        Cm = Fn.pad(Cm, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // q

    xc = xh.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    Bc = Bm.reshape(b, nc, q, n).to(_F32)
    Cc = Cm.reshape(b, nc, q, n).to(_F32)

    da = dtc * A[None, None, None, :]               # (b,nc,q,h) log-decay
    da_cs = torch.cumsum(da, dim=2)                  # within-chunk cumulative

    # 1) intra-chunk (diagonal blocks): (G * L) @ xdt, per (b, c, h)
    L = torch.exp(_segsum(torch.movedim(da, 2, 3)))             # (b,nc,h,q,q)
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)                  # (b,nc,q,q)
    xdt = xc * dtc[..., None]                                    # (b,nc,q,h,p)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", G[:, :, None] * L, xdt)

    # 2) chunk end-states
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)       # (b,nc,q,h)
    states = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                          xdt * decay_states[..., None])         # (b,nc,h,p,n)

    # 3) inter-chunk recurrence, a loop over the chunks
    chunk_decay = torch.exp(da_cs[:, :, -1, :])                  # (b,nc,h)
    carry = torch.zeros((b, h, p, n), dtype=_F32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)                           # the state *before* c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (b,nc,h,p,n)

    # 4) inter-chunk output
    state_decay_out = torch.exp(da_cs)                           # (b,nc,q,h)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) * \
        state_decay_out[..., None]

    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    return y.to(xh.dtype), carry


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor):
    """One-token recurrent update.  x: (B, H, P), dt: (B, H), Bm/Cm:
    (B, N), state: (B, H, P, N) -> (y (B, H, P), new_state)."""
    dec = torch.exp(dt * A[None, :])                             # (B,H)
    upd = (x.to(_F32) * dt.to(_F32)[..., None])[..., None] * \
        Bm.to(_F32)[:, None, None, :]
    new = state * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new, Cm.to(_F32))
    return y.to(x.dtype), new


def _dw_conv(x: torch.Tensor, kernel: torch.Tensor,
             cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv over the sequence.  x: (B, S, C), kernel:
    (W, C).  With ``cache`` (B, W-1, C): the single-step mode (S == 1),
    returning the updated cache."""
    w = kernel.shape[0]
    if cache is not None:
        buf = torch.cat([cache, x], dim=1)                       # (B, W, C)
        y = torch.einsum("bwc,wc->bc", buf, kernel)[:, None, :]
        return y.to(x.dtype), buf[:, 1:]
    S = x.shape[1]
    xp = Fn.pad(x, (0, 0, w - 1, 0))
    y = 0
    for i in range(w):                       # Python's sum(): 0 + t0 + ...
        y = y + xp[:, i:i + S] * kernel[i]
    return y.to(x.dtype), None


def mamba2_block(x: torch.Tensor, wts: dict, cfg: ModelConfig, ctx: ShardCtx,
                 state: Optional[dict] = None):
    """The Mamba-2 mixer.  x: (B, S, D) -> (partial out (B, S, D),
    new_state).

    wts: {"wz": (D, I_loc), "wx": (D, I_loc), "wbc": (D, 2N), "wdt":
          (D, Hl), "conv_x": (W, I_loc), "conv_bc": (W, 2N), "A_log":
          (Hl,), "D": (Hl,), "dt_bias": (Hl,), "norm": (I_loc,), "wo":
          (I_loc, D)}
    state: {"ssm": (B, Hl, P, N), "conv_x": (B, W-1, I_loc), "conv_bc":
            (B, W-1, 2N)}
    """
    B_, S, D = x.shape
    P = cfg.ssm_headdim
    N = cfg.ssm_state
    i_loc = wts["wx"].shape[1]
    h_loc = i_loc // P

    z = x @ wts["wz"]                                            # (B,S,I_loc)
    xi = x @ wts["wx"]
    bc = x @ wts["wbc"]                                          # (B,S,2N)
    dt = softplus((x @ wts["wdt"]).to(_F32) + wts["dt_bias"].to(_F32))
    A = -torch.exp(wts["A_log"].to(_F32))                        # (Hl,)

    decode = state is not None and S == 1
    if decode:
        xi, cx = _dw_conv(xi, wts["conv_x"], state["conv_x"])
        bc, cb = _dw_conv(bc, wts["conv_bc"], state["conv_bc"])
    else:
        xi, _ = _dw_conv(xi, wts["conv_x"])
        bc, _ = _dw_conv(bc, wts["conv_bc"])
    xi = Fn.silu(xi.to(_F32)).to(x.dtype)
    bc = Fn.silu(bc.to(_F32)).to(x.dtype)
    Bm, Cm = bc[..., :N], bc[..., N:]

    xh = xi.reshape(B_, S, h_loc, P)
    if decode:
        y, new_ssm = ssd_decode_step(xh[:, 0], dt[:, 0], A, Bm[:, 0],
                                     Cm[:, 0], state["ssm"])
        y = y[:, None]
        new_state = {"ssm": new_ssm, "conv_x": cx, "conv_bc": cb}
    else:
        y, final = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
        new_state = {"ssm": final, "conv_x": None, "conv_bc": None}
    y = y + xh * wts["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B_, S, i_loc)

    # gated RMSNorm over the (sharded) inner dim: psum the sum of squares
    yf = (y * Fn.silu(z.to(_F32)).to(x.dtype)).to(_F32)
    ss = psum_tp(torch.sum(yf * yf, dim=-1, keepdim=True), ctx)
    inner_total = i_loc * ctx.tp
    yn = yf * torch.rsqrt(ss / inner_total + cfg.norm_eps)
    yn = (yn * wts["norm"].to(_F32)).to(x.dtype)

    out = yn @ wts["wo"]                                   # partial over tp
    return out, new_state
