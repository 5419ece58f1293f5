"""Mesh-independent, atomic checkpointing; counterpart of
``repro.train.checkpoint``, with the same on-disk format.

Format: one ``.npz`` of *logical* tensors (storage layout undone via the
``models/sharding`` converters) + a msgpack sidecar with step/config.
Atomic: write to ``<dir>/tmp.<step>`` then ``os.replace`` — a crash
mid-write never corrupts the latest checkpoint.  ``keep`` bounds disk use.

Because tensors are stored logically, a checkpoint written by either
package, at any DP and TP size, restores into the other.  In the port each
rank holds only its shards: :func:`params_to_logical` takes every rank's
shard stacked over both axes (the trainer gathers them to rank 0, which
writes), and :func:`logical_to_params` returns one rank's slices (every
rank reads the file and keeps its own).
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import msgpack
import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        else:
            out[name] = (v.detach().cpu().numpy()
                         if isinstance(v, torch.Tensor) else np.asarray(v))
    return out


def _unflatten(flat):
    tree: dict = {}
    for name, v in flat.items():
        parts = name.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return tree


def save(ckpt_dir: str, step: int, logical_tree: dict, meta: dict,
         keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(logical_tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(msgpack.packb({"step": step, **meta}))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def load(ckpt_dir: str, step: Optional[int] = None) -> tuple[dict, dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.msgpack"), "rb") as f:
        meta = msgpack.unpackb(f.read())
    return _unflatten(flat), meta


# ---------------------------------------------------------------------------
# y-state migration: replicated -> sharded anchor leaves
# ---------------------------------------------------------------------------

def reshard_anchor(arr, target_shape: tuple) -> Any:
    """Migrate one anchor leaf from a pre-sharding checkpoint.

    Old checkpoints hold replicated anchors of shape ``(L?, m)``; the
    sharded layout stores ``(L?, tp, dp, shard)`` with ``m = dp * shard``
    (models/sharding.anchor_shape).  When the shapes correspond, reshape
    the replicated vector into its dp x shard slices and broadcast over
    tp — the values are identical, only the layout changes.  Anything else
    (already matching, or a genuinely different mesh) passes through
    untouched and falls into the trainer's elastic fresh-init fallback.
    """
    a = np.asarray(arr)
    t = tuple(target_shape)
    if (len(t) >= 3 and a.ndim == len(t) - 2
            and a.shape[:-1] == t[:-3] and a.shape[-1] == t[-2] * t[-1]):
        sliced = a.reshape(a.shape[:-1] + (1, t[-2], t[-1]))
        return np.broadcast_to(sliced, t).copy()
    return arr


def reshard_y(tree, target):
    """Recursively migrate a restored y-state tree toward ``target``'s
    layout (anchor leaves only; everything else passes through)."""
    if isinstance(tree, dict) and isinstance(target, dict):
        return {k: (reshard_anchor(tree[k], np.shape(target[k]))
                    if k == "anchor" and not isinstance(target[k], dict)
                    else reshard_y(tree[k], target[k]))
                for k in tree if k in target}
    return tree


# ---------------------------------------------------------------------------
# storage <-> logical round trips for whole parameter trees
# ---------------------------------------------------------------------------

def params_to_logical(params: dict, metas: dict, ctx) -> dict:
    """Storage tree {"layers": {...}, "top": {...}} of *every* rank's
    shards — stacked leaves (L, tp, dp, shard), top (tp, dp, shard), the
    reference's global layout — to a logical numpy tree."""
    from repro_torch.models.sharding import storage_to_logical
    out: dict = {}
    for grp, leaves in params.items():
        out[grp] = {}
        for name, arr in leaves.items():
            meta = metas[grp][name]
            a = torch.as_tensor(np.asarray(arr)) if not isinstance(
                arr, torch.Tensor) else arr.detach().cpu()
            if meta.scanned:
                out[grp][name] = np.stack(
                    [storage_to_logical(a[l], meta, ctx).numpy()
                     for l in range(a.shape[0])])
            else:
                out[grp][name] = storage_to_logical(a, meta, ctx).numpy()
    return out


def logical_to_params(logical: dict, metas: dict, ctx, dp_rank: int,
                      device=None, tp_rank: int = 0) -> dict:
    """Logical tree -> the storage slices (L?, 1, 1, shard) of the rank at
    DP index ``dp_rank`` and TP index ``tp_rank`` for the (possibly
    different) ctx."""
    from repro_torch.models.sharding import logical_to_storage
    out: dict = {}
    for grp, leaves in logical.items():
        out[grp] = {}
        for name, arr in leaves.items():
            meta = metas[grp][name]
            a = torch.as_tensor(np.asarray(arr))
            if meta.scanned:
                st = torch.stack([logical_to_storage(a[l], meta, ctx)
                                  for l in range(a.shape[0])])
                st = st[:, tp_rank:tp_rank + 1, dp_rank:dp_rank + 1]
            else:
                st = logical_to_storage(a, meta, ctx)[
                    tp_rank:tp_rank + 1, dp_rank:dp_rank + 1]
            out[grp][name] = st.contiguous().to(device)
    return out
