"""Anchored quantization state (the paper's distance-dependent regime);
counterpart of ``repro.core.qstate``.

Encoding ``x - anchor`` with the anchor pinned to the previous round's (or
step's) mean keeps the lattice coordinates ``|k| ~ y/s ~ q`` however large
``|x|`` grows, where raw coordinates ``round(x/s - u)`` would run past
f32's 24-bit mantissa and lose the dither.

:class:`QState` bundles that anchor with the per-bucket state:

  * ``y``      — (nb,) distance bound per bucket; lattice side
                 ``s_b = 2 y_b / (q-1)``;
  * ``anchor`` — flat (n,) anchor vector, or ``None`` for the zero anchor
                 (the same bits as a bare ``y``).

:func:`update_y` is the per-bucket transition driven by decode telemetry:
buckets with a detected decode failure escalate, clean buckets relax
toward the measured distance.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch


class QState(NamedTuple):
    """Anchored quantization state.

    y:      (nb,) f32 per-bucket distance bounds.
    anchor: flat (n,) f32 anchor vector (raw space, before bucketizing), or
            None for the zero anchor.
    """
    y: torch.Tensor
    anchor: Optional[torch.Tensor] = None


def as_qstate(state: Union[QState, torch.Tensor], *,
              anchor: Optional[torch.Tensor] = None) -> QState:
    """Promote a bare per-bucket ``y`` to a :class:`QState` (zero anchor
    unless ``anchor`` is given); a :class:`QState` passes through."""
    if isinstance(state, QState):
        return state
    return QState(y=torch.as_tensor(state, dtype=torch.float32),
                  anchor=anchor)


def uniform(nb: int, y, anchor: Optional[torch.Tensor] = None) -> QState:
    """The same bound ``y`` for every one of ``nb`` buckets (on ``y``'s
    device when it is a tensor)."""
    yt = torch.as_tensor(y, dtype=torch.float32)
    return QState(y=yt.expand(nb).clone(), anchor=anchor)


def update_y(y: torch.Tensor, fails_b: torch.Tensor, dist_b: torch.Tensor,
             *, decay: float = 0.99, escalate: float = 2.0,
             margin: float = 2.5, floor: float = 1e-8) -> torch.Tensor:
    """Per-bucket distance-bound transition from one round's telemetry.

    y, fails_b, dist_b: (..., nb).  Buckets with failures escalate
    ``y <- y * escalate``; clean buckets relax toward ``margin * dist_b``,
    clipped to [y/4, 4y] per step; ``dist_b == 0`` (nothing measured)
    leaves the bound unchanged.  The same operations in the same order as
    the reference, so the bits agree.
    """
    y = torch.as_tensor(y, dtype=torch.float32)
    clipped = torch.minimum(torch.maximum(margin * dist_b, 0.25 * y),
                            4.0 * y)
    candidate = torch.where(dist_b > floor, clipped, y)
    relaxed = decay * y + (1.0 - decay) * candidate
    return torch.clamp_min(torch.where(fails_b > 0, y * escalate, relaxed),
                           floor)
