"""The aggregation-node surface (counterpart of ``repro.agg.api``).

Every aggregation endpoint speaks the same three-verb protocol:

* ``ingest_frame(data, now)`` — feed one transport message (a client frame,
  or — for a tier — an upstream response); returns the response bytes the
  node wants sent.
* ``tick(now)`` — fire time/batch-based policy (drains, deadlines,
  retransmit requests, upstream forwarding); returns outbound bytes.
* ``published()`` — the in-order list of :class:`PublishedRound` outcomes.

The endpoints: the single-round flat server
(:class:`repro_torch.agg.server.AggServer`), the continuous-round engine
(:class:`repro_torch.agg.engine.AggEngine`) and the hierarchical tree
(:class:`repro_torch.agg.tree.TierAggregator` /
:class:`repro_torch.agg.tree.AggTree`).  A driver written against
:class:`AggNode` cannot tell them apart.

:class:`AggConfig` is the one composed knob surface: the round-contract
fields of :class:`~repro_torch.agg.service.ServiceConfig`, the cutover /
drain policy of :class:`~repro_torch.agg.engine.EngineConfig` and the tree
topology (``fanout`` / ``tiers``); ``service_config()`` /
``engine_config()`` project it onto the layer configs.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Protocol, runtime_checkable

import torch

from repro_torch.agg.transport import frame as wire

if TYPE_CHECKING:                                    # no import cycle at
    from repro_torch.agg.server import RoundStats    # runtime: hints only


@dataclasses.dataclass
class PublishedRound:
    """One published round's outcome + latency/staleness telemetry."""
    round_id: int
    spec: wire.RoundSpec
    anchor: Optional[torch.Tensor]  # (d,) f32 on the server's device: what
                                    # clients encoded against (None:
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


@dataclasses.dataclass(frozen=True)
class AggConfig:
    """One composed config for every aggregation topology: the round
    contract (:class:`~repro_torch.agg.service.ServiceConfig`), the
    engine's cutover / drain / admission policy
    (:class:`~repro_torch.agg.engine.EngineConfig`) and the tree topology,
    with the layer configs' defaults."""
    # ---- round contract (ServiceConfig) ----
    d: int
    q: int = 16
    bucket: int = 512
    rotate: bool = False
    y0: float = 1.0
    seed: int = 0
    max_attempts: int = 4
    anchored: bool = True
    mtu: int = 0
    window: int = 0
    y_decay: float = 0.75
    y_escalate: float = 2.0
    y_floor: float = 1e-6
    # ---- cutover / drain / admission policy (EngineConfig) ----
    quorum: int = 64
    round_deadline: float = 1.0
    min_clients: int = 1
    straggler_deadline: float = 0.25
    max_resends: int = 2
    drain_deadline: float = 1.0
    max_pending: Optional[int] = None
    max_live_rounds: int = 3
    # ---- tree topology (AggTree) ----
    fanout: int = 8               # max children per aggregation node
    tiers: int = 1                # tier layers between clients and the root

    _SERVICE_FIELDS = ("d", "q", "bucket", "rotate", "y0", "seed",
                       "max_attempts", "anchored", "mtu", "window",
                       "y_decay", "y_escalate", "y_floor")
    _ENGINE_FIELDS = ("quorum", "round_deadline", "min_clients",
                      "straggler_deadline", "max_resends", "drain_deadline",
                      "max_pending", "max_live_rounds")

    def service_config(self):
        """Project onto :class:`repro_torch.agg.service.ServiceConfig`."""
        from repro_torch.agg.service import ServiceConfig
        return ServiceConfig(
            **{f: getattr(self, f) for f in self._SERVICE_FIELDS})

    def engine_config(self):
        """Project onto :class:`repro_torch.agg.engine.EngineConfig`."""
        from repro_torch.agg.engine import EngineConfig
        return EngineConfig(
            **{f: getattr(self, f) for f in self._ENGINE_FIELDS})
