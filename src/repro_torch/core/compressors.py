"""Unified compressor zoo: the paper's method and every baseline it compares
to; counterpart of ``repro.core.compressors``.

All compressors share one interface, so the DME algorithms
(:mod:`repro_torch.core.dme`) and the benchmarks can swap them freely::

    payload = comp.encode(x, ctx, key)          # what goes on the wire
    x_hat   = comp.decode(payload, anchor, ctx)
    nbytes  = comp.wire_bytes(d)                # exact bytes on the wire

``ctx`` is a :class:`CompressorCtx` carrying the distance bound y (LQ
family), the shared rotation diagonal and the shared lattice offset.
``anchor`` is the decoder's own vector; only the lattice family uses it
(the paper's core idea).  Keys are :mod:`repro_torch.random` keys, and
every draw is made on the input's device.

Implemented (paper §9 comparisons):
  lq       — cubic-lattice quantization, LQSGD           (the paper)
  rlq      — + Walsh-Hadamard rotation, RLQSGD           (the paper, §6)
  qsgd_l2  — QSGD with l2-norm scaling [Alistarh+ 17]
  qsgd_linf— QSGD variant scaled by max|x|
  hadamard — Suresh+ 17: rotate, then uniform stochastic quantization
  terngrad — Wen+ 17: ternary {-1,0,1}·max|x|
  efsign   — Seide/Karimireddy sign-SGD with error feedback (stateful)
  topk     — magnitude top-k sparsification (indices+values)
  powersgd — Vogels+ 19 rank-r (stateful; benchmark-only, for matrices)
  fp32     — identity (naive averaging baseline)
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.core import lattice as L
from repro_torch.core import rotation as R


def _out_dtype(anchor: Optional[torch.Tensor]) -> torch.dtype:
    return anchor.dtype if anchor is not None else torch.float32


@dataclasses.dataclass(frozen=True)
class CompressorCtx:
    """Per-step shared context (same values on every machine)."""
    y: Any = 1.0                               # distance bound (LQ family)
    diag: Optional[torch.Tensor] = None        # shared rotation diagonal
    u: Optional[torch.Tensor] = None           # shared lattice offset


class Compressor:
    """Base: stateless functional compressor."""

    name: str = "base"
    needs_anchor: bool = False

    def encode(self, x: torch.Tensor, ctx: CompressorCtx, key=None):
        raise NotImplementedError

    def decode(self, payload, anchor: Optional[torch.Tensor],
               ctx: CompressorCtx) -> torch.Tensor:
        raise NotImplementedError

    def wire_bytes(self, d: int) -> int:
        raise NotImplementedError

    def roundtrip(self, x: torch.Tensor, ctx: CompressorCtx, key=None,
                  anchor: Optional[torch.Tensor] = None) -> torch.Tensor:
        """encode+decode locally (benchmark convenience)."""
        payload = self.encode(x, ctx, key)
        return self.decode(payload, x if anchor is None else anchor, ctx)


# ---------------------------------------------------------------------------
# The paper's method
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LatticeQ(Compressor):
    """LQSGD: cubic lattice, mod-q colors (paper §3/§9.1)."""
    q: int = 16
    pack: bool = True

    name = "lq"
    needs_anchor = True

    @property
    def spec(self) -> L.LatticeSpec:
        return L.LatticeSpec(self.q)

    def encode(self, x, ctx, key=None):
        colors, _ = L.lattice_encode(x, ctx.y, self.spec, key=key, u=ctx.u)
        if self.pack:
            return L.pack_colors(colors, self.spec.bits)
        return colors

    def decode(self, payload, anchor, ctx):
        colors = payload
        if self.pack:
            colors = L.unpack_colors(payload, anchor.shape[-1], self.spec.bits)
        return L.lattice_decode(colors, anchor, ctx.y, self.spec, u=ctx.u,
                                dtype=anchor.dtype)

    def wire_bytes(self, d):
        return L.wire_bytes(d, self.spec.bits) + 4   # + y scalar


@dataclasses.dataclass(frozen=True)
class RotatedLatticeQ(Compressor):
    """RLQSGD: Walsh-Hadamard rotation + cubic lattice (paper §6).

    ctx.y must be the post-rotation l-inf bound; encode and decode work in
    the rotated space and the decode anchor is rotated the same way.  With
    ``use_kernel=True`` the rotation goes through
    :func:`repro_torch.kernels.ops.fwht` (the CUDA kernel on a CUDA tensor,
    rows of 4 to 16384)."""
    q: int = 16
    pack: bool = True
    use_kernel: bool = False

    name = "rlq"
    needs_anchor = True

    @property
    def spec(self) -> L.LatticeSpec:
        return L.LatticeSpec(self.q)

    def encode(self, x, ctx, key=None):
        if ctx.diag is None:
            raise ValueError("rlq needs ctx.diag")
        xr = R.rotate(x, ctx.diag, use_kernel=self.use_kernel)
        colors, _ = L.lattice_encode(xr, ctx.y, self.spec, key=key, u=ctx.u)
        if self.pack:
            return L.pack_colors(colors, self.spec.bits)
        return colors

    def decode(self, payload, anchor, ctx):
        if ctx.diag is None:
            raise ValueError("rlq needs ctx.diag")
        d = anchor.shape[-1]
        ar = R.rotate(anchor, ctx.diag, use_kernel=self.use_kernel)
        colors = payload
        if self.pack:
            colors = L.unpack_colors(payload, ar.shape[-1], self.spec.bits)
        zr = L.lattice_decode(colors, ar, ctx.y, self.spec, u=ctx.u)
        return R.unrotate(zr, ctx.diag, d,
                          use_kernel=self.use_kernel).to(anchor.dtype)

    def wire_bytes(self, d):
        return L.wire_bytes(R.next_pow2(d), self.spec.bits) + 4


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

def _stochastic_levels(t: torch.Tensor, levels: int, key) -> torch.Tensor:
    """Stochastically round t in [0, levels] to an integer level."""
    lo = torch.floor(t)
    if key is None:
        return torch.round(t)
    frac = t - lo
    return lo + (_random.uniform(key, tuple(t.shape), device=t.device) < frac)


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """QSGD: x_hat = ||x|| * sign(x) * level/qlevel, stochastic levels.

    norm="l2" is the original; norm="linf" scales by max|x|."""
    qlevel: int = 8
    norm: str = "l2"

    needs_anchor = False

    @property
    def name(self):  # type: ignore[override]
        return f"qsgd_{self.norm}"

    def encode(self, x, ctx, key=None):
        xf = x.to(torch.float32)
        if self.norm == "l2":
            scale = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
        else:
            scale = torch.amax(xf.abs(), dim=-1, keepdim=True)
        scale = torch.clamp_min(scale, 1e-30)
        t = xf.abs() / scale * self.qlevel
        lev = _stochastic_levels(t, self.qlevel, key)
        return {"scale": scale, "sign": torch.sign(xf), "lev": lev}

    def decode(self, payload, anchor, ctx):
        out = payload["scale"] * payload["sign"] * payload["lev"] / self.qlevel
        return out.to(_out_dtype(anchor))

    def wire_bytes(self, d):
        bits = int(np.ceil(np.log2(self.qlevel + 1))) + 1   # level + sign
        return (d * bits + 7) // 8 + 8                      # + float64 norm


@dataclasses.dataclass(frozen=True)
class HadamardUniform(Compressor):
    """Suresh et al. 17: rotate with HD, uniform stochastic k-level quantize."""
    levels: int = 8

    name = "hadamard"
    needs_anchor = False

    def encode(self, x, ctx, key=None):
        if ctx.diag is None:
            raise ValueError("hadamard needs ctx.diag")
        xr = R.rotate(x, ctx.diag)
        mn = torch.amin(xr, dim=-1, keepdim=True)
        mx = torch.amax(xr, dim=-1, keepdim=True)
        span = torch.clamp_min(mx - mn, 1e-30)
        t = (xr - mn) / span * (self.levels - 1)
        lev = _stochastic_levels(t, self.levels - 1, key)
        return {"mn": mn, "span": span, "lev": lev, "d": x.shape[-1]}

    def decode(self, payload, anchor, ctx):
        xr = payload["mn"] + payload["lev"] / (self.levels - 1) * payload["span"]
        out = R.unrotate(xr, ctx.diag, payload["d"])
        return out.to(_out_dtype(anchor))

    def wire_bytes(self, d):
        bits = int(np.ceil(np.log2(self.levels)))
        return (R.next_pow2(d) * bits + 7) // 8 + 16


@dataclasses.dataclass(frozen=True)
class TernGrad(Compressor):
    name = "terngrad"
    needs_anchor = False

    def encode(self, x, ctx, key=None):
        xf = x.to(torch.float32)
        scale = torch.clamp_min(torch.amax(xf.abs(), dim=-1, keepdim=True),
                                1e-30)
        t = xf.abs() / scale
        if key is None:
            return {"scale": scale, "t": torch.sign(xf) * torch.round(t)}
        # float * bool in the reference is +0 where the draw is False
        b = _random.uniform(key, tuple(xf.shape), device=xf.device) < t
        return {"scale": scale, "t": torch.where(b, torch.sign(xf), 0.0)}

    def decode(self, payload, anchor, ctx):
        out = payload["scale"] * payload["t"]
        return out.to(_out_dtype(anchor))

    def wire_bytes(self, d):
        return (d * 2 + 7) // 8 + 4


@dataclasses.dataclass(frozen=True)
class EFSign(Compressor):
    """EF-SignSGD [Karimireddy+ 19].  Stateful: call via ef_roundtrip."""
    name = "efsign"
    needs_anchor = False

    def encode(self, x, ctx, key=None):
        xf = x.to(torch.float32)
        scale = torch.mean(xf.abs(), dim=-1, keepdim=True)
        return {"scale": scale, "sign": torch.sign(xf)}

    def decode(self, payload, anchor, ctx):
        out = payload["scale"] * payload["sign"]
        return out.to(_out_dtype(anchor))

    def wire_bytes(self, d):
        return (d + 7) // 8 + 4


def ef_roundtrip(comp: Compressor, x: torch.Tensor, err: torch.Tensor,
                 ctx: CompressorCtx, key=None
                 ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Error-feedback wrapper: compress (x + err), carry the residual."""
    corrected = x + err
    x_hat = comp.roundtrip(corrected, ctx, key)
    return x_hat, corrected - x_hat


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Magnitude top-k.  Among tied magnitudes torch may pick other indices
    than XLA, with the same decoded vector."""
    frac: float = 0.01
    name = "topk"
    needs_anchor = False

    def k_of(self, d: int) -> int:
        return max(1, int(d * self.frac))

    def encode(self, x, ctx, key=None):
        xf = x.to(torch.float32)
        k = self.k_of(x.shape[-1])
        _, idx = torch.topk(xf.abs(), k, dim=-1)
        sel = torch.gather(xf, -1, idx)
        return {"idx": idx, "vals": sel, "d": x.shape[-1]}

    def decode(self, payload, anchor, ctx):
        vals = payload["vals"]
        out = torch.zeros(vals.shape[:-1] + (payload["d"],),
                          dtype=torch.float32, device=vals.device)
        out.scatter_(-1, payload["idx"], vals)
        return out.to(_out_dtype(anchor))

    def wire_bytes(self, d):
        return self.k_of(d) * 8   # 4B idx + 4B val


@dataclasses.dataclass(frozen=True)
class PowerSGDLike(Compressor):
    """Rank-r one-power-iteration compressor for (m, n) matrices.

    Benchmark-only; reshapes the flat vector to (m, d // m)."""
    rank: int = 4
    rows: int = 64
    name = "powersgd"
    needs_anchor = False

    def _shape(self, d: int) -> "tuple[int, int]":
        m = min(self.rows, d)
        while d % m:
            m -= 1
        return m, d // m

    def encode(self, x, ctx, key=None):
        d = x.shape[-1]
        m, n = self._shape(d)
        M = x.to(torch.float32).reshape(tuple(x.shape[:-1]) + (m, n))
        if key is None:
            key = _random.PRNGKey(0)
        Q = _random.normal(key, tuple(x.shape[:-1]) + (n, self.rank),
                           device=x.device)
        P, _ = torch.linalg.qr(M @ Q)
        Qt = M.transpose(-1, -2) @ P
        return {"P": P, "Q": Qt, "d": d}

    def decode(self, payload, anchor, ctx):
        M = payload["P"] @ payload["Q"].transpose(-1, -2)
        out = M.reshape(tuple(M.shape[:-2]) + (payload["d"],))
        return out.to(_out_dtype(anchor))

    def wire_bytes(self, d):
        m, n = self._shape(d)
        return (m + n) * self.rank * 4


@dataclasses.dataclass(frozen=True)
class FP32(Compressor):
    name = "fp32"
    needs_anchor = False

    def encode(self, x, ctx, key=None):
        return x.to(torch.float32)

    def decode(self, payload, anchor, ctx):
        return payload.to(_out_dtype(anchor))

    def wire_bytes(self, d):
        return d * 4


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def make_compressor(name: str, **kw) -> Compressor:
    name = name.lower()
    table = {
        "lq": LatticeQ,
        "rlq": RotatedLatticeQ,
        "qsgd_l2": partial(QSGD, norm="l2"),
        "qsgd_linf": partial(QSGD, norm="linf"),
        "hadamard": HadamardUniform,
        "terngrad": TernGrad,
        "efsign": EFSign,
        "topk": TopK,
        "powersgd": PowerSGDLike,
        "fp32": FP32,
    }
    if name not in table:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(table)}")
    return table[name](**kw)


ALL_COMPRESSORS = ("lq", "rlq", "qsgd_l2", "qsgd_linf", "hadamard", "terngrad",
                   "efsign", "topk", "powersgd", "fp32")
