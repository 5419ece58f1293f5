"""Carry a round's state across from the reference package.

The port never imports the reference.  A caller that holds a reference
``RoundSpec`` passes ``dataclasses.asdict(spec)`` (the nested ``cfg``
included) to :func:`round_spec`, a reference ``QState``'s arrays to
:func:`qstate_from_numpy`, and numpy arrays (an anchor, a client vector)
to :func:`tensor`; both sides of a comparison are then built from the same
numbers.  :func:`train_state_from_numpy` carries a reference training
state (its global storage arrays) across as one rank's slices,
:func:`params_from_numpy` a parameter tree, the encoder-decoder's
``{"enc", "dec", "top"}`` one included, and :func:`cache_from_numpy` a
serving cache.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.agg.transport.frame import RoundSpec
from repro_torch.core.qstate import QState
from repro_torch.dist.collectives import QSyncConfig


def round_spec(fields: dict) -> RoundSpec:
    """The port's :class:`RoundSpec` of a reference spec's field dict."""
    fields = dict(fields)
    cfg = fields.pop("cfg")
    if not isinstance(cfg, QSyncConfig):
        cfg = QSyncConfig(**dict(cfg))
    yb = fields.get("y_buckets")
    if yb is not None:
        fields["y_buckets"] = tuple(float(v) for v in yb)
    return RoundSpec(cfg=cfg, **fields)


def tensor(a, device=None, dtype=torch.float32) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor of ``dtype`` on ``device``
    (the CUDA device unless another is named)."""
    return torch.from_numpy(np.array(a, copy=True)).to(
        device=resolve_device(device), dtype=dtype)


def qstate_from_numpy(y, anchor=None, device=None) -> QState:
    """The port's :class:`QState` of a reference state's per-bucket ``y``
    and optional flat ``anchor`` (numpy arrays or array-likes), on
    ``device`` (the CUDA device unless another is named)."""
    dev = resolve_device(device)
    return QState(y=tensor(y, dev),
                  anchor=None if anchor is None else tensor(anchor, dev))


def _rank_slice(a, dp_rank: int, tp_rank: int, dev) -> torch.Tensor:
    """(L?, tp, dp, shard) global storage -> (L?, 1, 1, shard) of the rank
    at (tp_rank, dp_rank)."""
    a = np.asarray(a)
    return tensor(a[..., tp_rank:tp_rank + 1, dp_rank:dp_rank + 1, :], dev)


def params_from_numpy(params_np: dict, rank: int, device=None,
                      tp_rank: int = 0) -> dict:
    """A reference parameter (or moment) tree of global storage arrays
    ``(L?, tp, dp, shard)`` — groups ``layers``/``top``, or the
    encoder-decoder's ``enc``/``dec``/``top`` — as the ``(L?, 1, 1,
    shard)`` slices of the rank at DP index ``rank`` and TP index
    ``tp_rank``, on ``device`` (the CUDA device unless another is named)."""
    dev = resolve_device(device)
    return {grp: {k: _rank_slice(v, rank, tp_rank, dev)
                  for k, v in leaves.items()}
            for grp, leaves in params_np.items()}


def train_state_from_numpy(state_np: dict, cfg, ctx, rank: int,
                           device=None, tp_rank: int = 0) -> dict:
    """A reference training state, as numpy arrays — params and optimizer
    moments as global storage arrays ``(L?, tp, dp, shard)``, the ``y``
    tree (sharded anchors global too), ``step`` and ``key`` — as the state
    of the port's rank at DP index ``rank`` and TP index ``tp_rank``:
    ``(L?, 1, 1, shard)`` slices on ``device`` (the CUDA device unless
    another is named)."""
    dev = resolve_device(device)

    def tree(t):
        return params_from_numpy(t, rank, dev, tp_rank)

    def y_leaf(v):
        if isinstance(v, dict):
            a = np.asarray(v["anchor"])
            if ctx.anchor_sharded:
                a = a[..., tp_rank:tp_rank + 1, rank:rank + 1, :]
            return {"y": tensor(v["y"], dev), "anchor": tensor(a, dev)}
        return tensor(v, dev)

    key = np.asarray(state_np["key"]).astype(np.uint32).reshape(-1)
    return {"params": tree(state_np["params"]),
            "opt": {k: tree(v) for k, v in state_np["opt"].items()},
            "y": {grp: {k: y_leaf(v) for k, v in leaves.items()}
                  for grp, leaves in state_np["y"].items()},
            "step": int(np.asarray(state_np["step"])),
            "key": (int(key[0]), int(key[1]))}


def cache_from_numpy(cache_np: dict, dp_rank: int, tp_rank: int, dp: int,
                     device=None) -> dict:
    """A reference serving cache of global layout — each leaf ``(tp, L,
    B_global, ...)``, the hybrid's ``tail*`` leaves ``(tp, B_global,
    ...)``, the batch sharded over the ``dp`` DP ranks — as the local cache
    of the rank at DP index ``dp_rank`` and TP index ``tp_rank``: its TP
    row and its ``B_global / dp`` batch rows, each leaf in
    ``serve.cache_dtype`` (int8 K/V where ``k_scale`` is present) on
    ``device`` (the CUDA device unless another is named).  Numpy has no
    bf16: bf16 leaves come as float32 or ml_dtypes' bfloat16."""
    from repro_torch.models.serve import cache_dtype

    dev = resolve_device(device)
    quant = "k_scale" in cache_np
    out = {}
    for k, v in cache_np.items():
        a = np.asarray(v)[tp_rank]
        if a.dtype not in (np.int8, np.float32):
            a = a.astype(np.float32)
        bpos = 0 if k.startswith("tail") else 1
        b_loc = a.shape[bpos] // dp
        a = np.take(a, range(dp_rank * b_loc, (dp_rank + 1) * b_loc),
                    axis=bpos)
        out[k] = tensor(a, dev, cache_dtype(k, quant))
    return out
