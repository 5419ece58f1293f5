"""Paper algorithms: MeanEstimation / VarianceReduction (§4); counterpart of
``repro.core.dme``.

Faithful reference implementations over a stacked input ``xs: (n, d)``,
n machines' vectors on one device; every draw is made on that device.

Algorithm 3 (star):   a random leader gathers colors, decodes against its
own input, averages, re-broadcasts quantized; everyone decodes against
their own input.

Algorithm 4 (tree):   sample T = min(m, n) machines; binary tree over them;
average and re-quantize with Q_{y/m^2, m^3} at every internal node;
broadcast.

VarianceReduction reduces to MeanEstimation with y = 2*sigma*sqrt(alpha*n)
(Theorem 17).

The mean over machines is a sum in row order followed by one division, so
the card and the CPU compute it in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import random as _random
from repro_torch.core.compressors import Compressor, CompressorCtx, LatticeQ
from repro_torch.core.lattice import shared_offset


@dataclasses.dataclass
class DMEResult:
    est: torch.Tensor               # (n, d) per-machine outputs
    # (n,) wire bits sent by each machine; int64, where the reference's
    # int32 wraps past 2^31 bits (the butterfly or a q = 64 tree at
    # d ~ 2.8e8)
    bits_per_machine: torch.Tensor
    decode_ok: torch.Tensor         # 0-d bool: all outputs agree


def _row_mean(rows) -> torch.Tensor:
    """Mean of a sequence of equal-shape tensors: a sum in order, then a
    division by the count."""
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc / len(rows)


def _agree(outs: torch.Tensor, tol: float) -> torch.Tensor:
    return torch.all((outs - outs[0]).abs() <= tol * (1.0 + outs[0].abs()))


def mean_estimation_star(xs: torch.Tensor, y, comp: Compressor, key,
                         ctx: Optional[CompressorCtx] = None,
                         leader: Optional[int] = None) -> DMEResult:
    """Paper Algorithm 3 on inputs xs: (n, d)."""
    n, d = xs.shape
    ctx = dataclasses.replace(ctx or CompressorCtx(), y=y)
    kl, kb, *ks = _random.split(key, n + 2)
    if leader is None:
        leader = int(_random.randint(kl, (), 0, n, device=xs.device))
    x_leader = xs[leader]

    # Phase 1: everyone -> leader; leader decodes against its own input.
    decoded = [comp.decode(comp.encode(xs[v], ctx, ks[v]), x_leader, ctx)
               for v in range(n)]
    mu_hat = _row_mean(decoded)

    # Phase 2: leader -> everyone; each decodes against its own input.
    payload = comp.encode(mu_hat, ctx, kb)
    outs = torch.stack([comp.decode(payload, xs[v], ctx) for v in range(n)])

    bits = torch.full((n,), comp.wire_bytes(d) * 8, dtype=torch.int64,
                      device=xs.device)
    return DMEResult(outs, bits, _agree(outs, 1e-6))


def mean_estimation_tree(xs: torch.Tensor, y, m: int, key,
                         q_override: Optional[int] = None,
                         ctx: Optional[CompressorCtx] = None) -> DMEResult:
    """Paper Algorithm 4: binary-tree aggregation with Q_{y/m^2, m^3}.

    q = m^3 is capped at 2^16 colors per coordinate (the cap only affects
    constants)."""
    n, d = xs.shape
    t = min(m, n)
    # power-of-two leaf count (paper: "we may assume it is a power of 2")
    t = 1 << int(np.floor(np.log2(max(t, 1))))
    kperm, key = _random.split(key)
    perm = _random.permutation(kperm, n, device=xs.device)[:t]
    leaves = xs[perm.long()]

    # Q_{y/m^2, m^3} on the cubic lattice: side s = 2y/(q-1), decode margin
    # (q-1)s/2 = y, per-hop error s/2 = y/(m^3-1)
    q = q_override or min(int(m) ** 3, 1 << 16)
    comp = LatticeQ(q=q)
    ctx = dataclasses.replace(ctx or CompressorCtx(), y=y)

    level = leaves
    while level.shape[0] > 1:
        key, *ks = _random.split(key, level.shape[0] // 2 + 1)
        nxt = []
        for i in range(level.shape[0] // 2):
            a, b = level[2 * i], level[2 * i + 1]
            a_dec = comp.decode(comp.encode(a, ctx, ks[i]), b, ctx)
            nxt.append((a_dec + b) * 0.5)
        level = torch.stack(nxt)
    root = level[0]

    key, kb = _random.split(key)
    payload = comp.encode(root, ctx, kb)
    outs = torch.stack([comp.decode(payload, xs[v], ctx) for v in range(n)])
    bits = torch.full((n,), comp.wire_bytes(d) * 8, dtype=torch.int64,
                      device=xs.device)
    return DMEResult(outs, bits, _agree(outs, 1e-6))


def variance_reduction(xs: torch.Tensor, sigma: float, comp: Compressor, key,
                       alpha: float = 4.0,
                       ctx: Optional[CompressorCtx] = None,
                       topology: str = "star") -> DMEResult:
    """Theorem 17 reduction: VR via ME with y = 2*sigma*sqrt(alpha*n)."""
    n = xs.shape[0]
    y = 2.0 * sigma * float(np.sqrt(alpha * n))
    if topology == "star":
        return mean_estimation_star(xs, y, comp, key, ctx)
    return mean_estimation_tree(xs, y, m=n, key=key, ctx=ctx)


def butterfly_mean(xs: torch.Tensor, y, comp: Compressor, key,
                   ctx: Optional[CompressorCtx] = None) -> DMEResult:
    """Recursive doubling: log2(n) rounds; in round k machine i exchanges
    quantized estimates with machine i XOR 2^k and averages.  A shared
    dither per round makes every machine's output bitwise equal."""
    n, d = xs.shape
    if n & (n - 1):
        raise ValueError(f"butterfly needs power-of-two n, got {n}")
    cur = xs
    bits = 0
    for r in range(int(np.log2(n))):
        key, ku = _random.split(key)
        u = shared_offset(ku, (d,), device=xs.device)
        rctx = dataclasses.replace(ctx or CompressorCtx(), y=y, u=u)
        stride = 1 << r
        payloads = [comp.encode(cur[i], rctx) for i in range(n)]
        nxt = []
        for i in range(n):
            zii = comp.decode(payloads[i], cur[i], rctx)       # own point
            zij = comp.decode(payloads[i ^ stride], cur[i], rctx)
            nxt.append((zii + zij) * 0.5)
        cur = torch.stack(nxt)
        bits += comp.wire_bytes(d) * 8
    bits_t = torch.full((n,), bits, dtype=torch.int64, device=xs.device)
    return DMEResult(cur, bits_t, _agree(cur, 1e-5))
