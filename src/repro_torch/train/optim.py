"""ZeRO-sharded optimizers (AdamW, SGD-momentum); counterpart of
``repro.train.optim``.

Optimizer states live in the same flat storage layout as the parameters
(``models/sharding.py``), so every update is local to the rank's shard:
the only communication on the optimizer's path is the quantized gradient
reduce-scatter the backward already ran.  ``state_dtype`` sets the moment
dtype (f32, or bf16 for low-memory runs); master weights are f32.

Scalars (learning rate, bias corrections, clip factor) are 0-d f32
tensors, as the reference's traced scalars are, so every step rounds in
f32.  The reference's compiled program contracts its mul-adds into FMAs
(see :func:`apply_update`); the port rounds those once too, with
:func:`repro_torch.core.lattice.fma_f32`, and so equals it bit for bit.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.lattice import fma_f32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | momentum
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    state_dtype: str = "float32"   # "bfloat16" => low-mem mode
    grad_clip: float = 1.0         # global-norm clip (0 disables)
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _t(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (warmup, then cosine to min_lr_ratio),
    a 0-d f32 tensor on the CPU.

    Rounded as the reference's compiled step rounds it: each division by
    a constant becomes a product with the constant's f32 reciprocal, the
    cosine is correctly rounded, and
    ``min_lr_ratio + (1 - min_lr_ratio) * cos_term`` is one FMA."""
    s = _t(float(step))
    warm = torch.minimum(s * _t(1.0 / max(cfg.warmup, 1)), _t(1.0))
    inv = _t(1.0 / max(cfg.decay_steps - cfg.warmup, 1))
    prog = torch.clamp((s - _t(cfg.warmup)) * inv, 0.0, 1.0)
    cos = torch.cos((_t(math.pi) * prog).double()).to(torch.float32)
    half = _t(0.5) * (_t(1.0) + cos)
    scale = fma_f32(_t(1 - cfg.min_lr_ratio), half, _t(cfg.min_lr_ratio))
    return _t(cfg.lr) * warm * scale


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    dt = getattr(torch, cfg.state_dtype)

    def zeros(tree):
        return {k: (zeros(v) if isinstance(v, dict)
                    else torch.zeros(v.shape, dtype=dt, device=v.device))
                for k, v in tree.items()}
    if cfg.name == "adamw":
        return {"m": zeros(params), "v": zeros(params)}
    return {"m": zeros(params)}


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (the f64 root rounded to f32 is;
    torch's vectorized f32 root on the CPU is not always)."""
    return torch.sqrt(x.double()).to(torch.float32)


def _map(fn, *trees):
    """Apply ``fn`` leafwise over dicts of the same structure; returns a
    tuple of trees when ``fn`` returns a tuple."""
    first = trees[0]
    outs = {k: (_map(fn, *(t[k] for t in trees)) if isinstance(first[k], dict)
                else fn(*(t[k] for t in trees))) for k in first}
    return outs


# elements of a leaf one update step takes at a time: the once-rounded
# mul-adds and the root go through f64 temporaries, about 40 bytes an
# element, so a whole 262 M-element shard (recurrentgemma-9b's vocab
# leaves at dp 2, tp 2) would hold about 10 GB of them
UPDATE_CHUNK = 1 << 24


def _chunked(fn, *ts):
    """``fn(*ts)`` for an elementwise ``fn`` returning a tuple of tensors
    shaped like ``ts[0]``, taken over slices of the last dim of about
    ``UPDATE_CHUNK`` elements each: the same bits, bounded temporaries."""
    p = ts[0]
    if p.dim() == 0 or p.numel() <= UPDATE_CHUNK:
        return fn(*ts)
    step = max(1, UPDATE_CHUNK * p.shape[-1] // p.numel())
    outs = None
    for c0 in range(0, p.shape[-1], step):
        part = fn(*(t[..., c0:c0 + step] for t in ts))
        if outs is None:
            outs = tuple(torch.empty(p.shape, dtype=x.dtype, device=x.device)
                         for x in part)
        for o, x in zip(outs, part):
            o[..., c0:c0 + step] = x
    return outs


def _unzip(tree: dict, i: int) -> dict:
    return {k: (_unzip(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def apply_update(params: dict, grads: dict, opt_state: dict, step,
                 cfg: OptConfig, global_grad_norm=None):
    """Shard-local update; params, grads and opt_state share one layout.

    global_grad_norm: the DP-global norm, for clipping across shards.  The
    reference's compiled step contracts ``b1*m + (1-b1)*g``,
    ``b2*v + ((1-b2)*g)*g``, ``u + wd*p`` and ``p - lr*(...)`` into FMAs
    (the first product of each pair exact inside the FMA); the port rounds
    each of them once too."""
    lr = lr_at(cfg, step)
    clip = _t(1.0)
    if cfg.grad_clip > 0 and global_grad_norm is not None:
        gn = torch.as_tensor(global_grad_norm, dtype=torch.float32).cpu()
        clip = torch.minimum(_t(1.0), _t(cfg.grad_clip)
                             / torch.maximum(gn, _t(1e-12)))

    if cfg.name == "adamw":
        b1, b2 = _t(cfg.b1), _t(cfg.b2)
        t = _t(float(step)) + 1.0
        c1 = 1.0 / (1.0 - torch.pow(b1, t))
        c2 = 1.0 / (1.0 - torch.pow(b2, t))
        wd, eps = _t(cfg.weight_decay), _t(cfg.eps)
        one_b1, one_b2 = _t(1 - cfg.b1), _t(1 - cfg.b2)

        def upd(p, g, m, v):
            dev = p.device
            gf = g.to(torch.float32) * clip.to(dev)
            m2 = fma_f32(b1.to(dev).expand_as(gf), m.to(torch.float32),
                         one_b1.to(dev) * gf)
            v2 = fma_f32(b2.to(dev).expand_as(gf), v.to(torch.float32),
                         (one_b2.to(dev) * gf) * gf)
            u = (m2 * c1.to(dev)) / (_sqrt(v2 * c2.to(dev)) + eps.to(dev))
            p2 = fma_f32(-lr.to(dev).expand_as(p),
                         fma_f32(wd.to(dev).expand_as(p), p, u), p)
            return p2, m2.to(m.dtype), v2.to(v.dtype)

        out = _map(lambda *t: _chunked(upd, *t), params, grads,
                   opt_state["m"], opt_state["v"])
        return _unzip(out, 0), {"m": _unzip(out, 1), "v": _unzip(out, 2)}

    mom, wd = _t(cfg.momentum), _t(cfg.weight_decay)

    def upd_m(p, g, m):
        dev = p.device
        gf = g.to(torch.float32) * clip.to(dev)
        m2 = fma_f32(mom.to(dev).expand_as(gf), m.to(torch.float32), gf)
        p2 = fma_f32(-lr.to(dev).expand_as(p),
                     fma_f32(wd.to(dev).expand_as(p), p, m2), p)
        return p2, m2.to(m.dtype)

    out = _map(lambda *t: _chunked(upd_m, *t), params, grads,
               opt_state["m"])
    return _unzip(out, 0), {"m": _unzip(out, 1)}


def local_sq_norm(grads: dict) -> torch.Tensor:
    """Sum of squares of the local shards (summed over DP for the global
    norm)."""
    total = None
    for v in grads.values():
        s = (local_sq_norm(v) if isinstance(v, dict)
             else torch.sum(v.to(torch.float32) ** 2))
        total = s if total is None else total + s
    return total
