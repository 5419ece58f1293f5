"""The aggregation-node surface (counterpart of ``repro.agg.api``).

Every aggregation endpoint speaks the same three-verb protocol:

* ``ingest_frame(data, now)`` — feed one transport message (a client frame,
  or — for a tier — an upstream response); returns the response bytes the
  node wants sent.
* ``tick(now)`` — fire time/batch-based policy (drains, deadlines,
  retransmit requests, upstream forwarding); returns outbound bytes.
* ``published()`` — the in-order list of :class:`PublishedRound` outcomes.

The port so far has one endpoint, the flat
:class:`repro_torch.agg.server.AggServer`.  The composed ``AggConfig`` of
the reference projects onto the service and engine configs, which the port
does not have yet, so it is not carried here.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.agg.transport import frame as wire

if TYPE_CHECKING:                                    # no import cycle at
    from repro_torch.agg.server import RoundStats    # runtime: hints only


@dataclasses.dataclass
class PublishedRound:
    """One published round's outcome + latency/staleness telemetry."""
    round_id: int
    spec: wire.RoundSpec
    anchor: Optional[np.ndarray]    # what clients encoded against (None:
                                    # unanchored round)
    mean: torch.Tensor              # (d,) f32 on the server's device
    stats: "RoundStats"
    accepted: frozenset             # client ids in the published mean
    opened_at: float
    sealed_at: float
    published_at: float
    anchor_round: int               # round whose mean this round anchored
                                    # against (0 = warm start)
    staleness: float                # published_at - anchor's publish time
                                    # (0.0 for warm-start anchors)

    @property
    def latency(self) -> float:
        """Open -> published round latency (driver clock units)."""
        return self.published_at - self.opened_at

    @property
    def staleness_rounds(self) -> int:
        """Anchor lag in rounds (0 for warm-start anchors)."""
        return self.round_id - self.anchor_round if self.anchor_round else 0


class PublishedLog(list):
    """A list of :class:`PublishedRound` that is also callable, so both
    ``node.published`` (attribute) and ``node.published()`` (the protocol
    verb) read the history."""

    def __call__(self) -> "list[PublishedRound]":
        return list(self)


@runtime_checkable
class AggNode(Protocol):
    """The structural protocol every aggregation endpoint implements.

    ``ingest_frame`` / ``tick`` return *outbound transport bytes* — each
    item is a complete frame or response message; the driver owns routing.
    ``now`` is whatever monotonic clock the driver uses; nodes are
    clock-agnostic and fire all policy from these two entry points.
    """

    def ingest_frame(self, data: bytes, now: float = 0.0) -> "list[bytes]":
        """Feed one arriving transport message; returns responses/frames."""
        ...

    def tick(self, now: float = 0.0) -> "list[bytes]":
        """Fire due time-based policy; returns responses/frames."""
        ...

    def published(self) -> "list[PublishedRound]":
        """In-order outcomes of every round this node has published."""
        ...
