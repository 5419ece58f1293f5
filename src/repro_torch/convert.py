"""Carry a round's state across from the reference package.

The port never imports the reference.  A caller that holds a reference
``RoundSpec`` passes ``dataclasses.asdict(spec)`` (the nested ``cfg``
included) to :func:`round_spec`, a reference ``QState``'s arrays to
:func:`qstate_from_numpy`, and numpy arrays (an anchor, a client vector)
to :func:`tensor`; both sides of a comparison are then built from the same
numbers.
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
