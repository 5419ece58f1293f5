"""Multi-round aggregation service: anchored QState + round life-cycle;
counterpart of ``repro.agg.service``.

**QState keeper** — :class:`AggService` owns what persists across rounds:
round k+1's contract is derived from the latest published round.

  * **anchor** — round k+1's anchor is the latest published mean, pinned in
    the RoundSpec by its CRC-32 digest (a client encoding against a stale
    anchor is REJECTed).  Under the continuous-round engine round k+1 opens
    while round k still drains, so its anchor lags; :attr:`Round.
    anchor_round` records the lag for the staleness telemetry.
  * **per-bucket y** — distance bounds advance from published decode
    telemetry through :func:`repro_torch.core.qstate.update_y`: buckets
    implicated in decode failures escalate, clean buckets relax toward the
    observed distances.
  * **per-round seed** — ``rounds.fold_seed(cfg.seed, round_id)``.

The state is device tensors on the service's device (the CUDA device
unless ``device="cpu"``): ``y`` is (nb,) f32 and ``anchor`` (d,) f32, so a
full-width chain never moves a mean through the host except to take the
anchor's digest.

**Round life-cycle state machine** — :class:`Round` walks one round through

    OPEN ──seal──> SEALING ──all admitted resolved──> DRAINED ──> PUBLISHED

Transitions are one-way and guarded (an illegal one raises), and rounds
publish strictly in round-id order (the anchor chain is sequential).

Lockstep usage (one round at a time)::

    svc = AggService(ServiceConfig(d=4096, bucket=512, y0=0.5))
    for _ in range(rounds):
        spec, anchor = svc.begin_round()
        server = svc.make_server()
        ... feed payloads from AggClient(spec, cid, x, anchor=anchor) ...
        mean, stats = svc.end_round(server)

Continuous usage (overlapping rounds) goes through
:class:`repro_torch.agg.engine.AggEngine`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

import repro_torch.obs as _obs
from repro_torch import resolve_device
from repro_torch.agg import rounds
from repro_torch.agg.server import AggServer, RoundStats
from repro_torch.agg.transport import frame as wire
from repro_torch.core import qstate as QS
from repro_torch.dist.collectives import QSyncConfig, flat_size_padded


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Static config of a multi-round aggregation service."""
    d: int
    q: int = 16
    bucket: int = 512
    rotate: bool = False
    y0: float = 1.0
    seed: int = 0
    max_attempts: int = 4
    anchored: bool = True       # False: every round keeps the zero anchor
    mtu: int = 0                # transport chunk size in bytes (0: one
                                # frame per payload)
    window: int = 0             # send-window credit in chunks (0: blast)
    y_decay: float = 0.75       # per-round relaxation toward measured dist
    y_escalate: float = 2.0     # per-bucket escalation on decode failure
    y_floor: float = 1e-6

    @property
    def qcfg(self) -> QSyncConfig:
        return QSyncConfig(q=self.q, bucket=self.bucket, rotate=self.rotate)

    @property
    def nb(self) -> int:
        return flat_size_padded(self.d, self.qcfg) // self.bucket


class RoundState(enum.Enum):
    OPEN = "open"            # admitting new clients
    SEALING = "sealing"      # cut over: draining admitted clients only
    DRAINED = "drained"      # every admitted client resolved
    PUBLISHED = "published"  # mean finalized and fed into the QState


class Round:
    """One aggregation round's life-cycle around its :class:`AggServer`.

    Created by :meth:`AggService.open_round`; the engine (or the lockstep
    wrappers) drives the transitions.  Timestamps are whatever clock the
    driver passes."""

    def __init__(self, spec: wire.RoundSpec, anchor: torch.Tensor,
                 server: AggServer, anchor_round: int, opened_at: float = 0.0):
        self.spec = spec
        self.anchor = anchor              # the server's reference vector
        self.server = server
        self.anchor_round = anchor_round  # round whose published mean this
                                          # round anchors against (0 = warm
                                          # start / zero anchor)
        self.state = RoundState.OPEN
        self.opened_at = opened_at
        self.sealed_at: Optional[float] = None
        self.drained_at: Optional[float] = None
        self.published_at: Optional[float] = None
        self.mean: Optional[torch.Tensor] = None
        self.stats: Optional[RoundStats] = None

    @property
    def round_id(self) -> int:
        return self.spec.round_id

    @property
    def client_anchor(self) -> "Optional[torch.Tensor]":
        """What clients must encode against (None in unanchored rounds)."""
        return self.anchor if self.spec.anchored else None

    def _expect(self, state: RoundState) -> None:
        if self.state is not state:
            raise RuntimeError(
                f"round {self.round_id}: illegal transition from "
                f"{self.state.value} (expected {state.value})")

    def seal(self, now: float = 0.0, next_round_id: int = 0) -> None:
        """OPEN -> SEALING: stop admitting new clients (cutover).

        ``next_round_id`` is the round now open for admission — late
        newcomers' non-terminal RETRY responses point there."""
        self._expect(RoundState.OPEN)
        self.server.seal(next_round_id)
        self.state = RoundState.SEALING
        self.sealed_at = now
        self._trace_state(now)

    def mark_drained(self, now: float = 0.0) -> None:
        """SEALING -> DRAINED: every admitted client has an outcome."""
        self._expect(RoundState.SEALING)
        if self.server.unresolved:
            raise RuntimeError(
                f"round {self.round_id}: {len(self.server.unresolved)} "
                f"admitted clients still unresolved")
        self.state = RoundState.DRAINED
        self.drained_at = now
        self._trace_state(now)

    def publish(self, now: float = 0.0) -> "tuple[torch.Tensor, RoundStats]":
        """Walk whatever remains of the life-cycle and finalize.

        From OPEN/SEALING this is the forced path: staged payloads are
        drained first, then still-unresolved stragglers are expired
        without a verdict, then the mean over the accepted clients is
        finalized.  Idempotent once PUBLISHED."""
        if self.state is RoundState.PUBLISHED:
            return self.mean, self.stats
        if self.state is RoundState.OPEN:
            self.seal(now)
        if self.state is RoundState.SEALING:
            self.server.drain()
            for cid in self.server.unresolved:
                self.server.expire_client(cid)
            self.mark_drained(now)
        self._expect(RoundState.DRAINED)
        self.mean, self.stats = self.server.finalize()
        self.state = RoundState.PUBLISHED
        self.published_at = now
        self._trace_state(now)
        return self.mean, self.stats

    def _trace_state(self, now: float) -> None:
        if _obs.tracing_enabled():
            _obs.tracer().event("state", parent=("round", self.round_id),
                                t=now, round=self.round_id,
                                state=self.state.value)


class AggService:
    """Coordinates successive anchored rounds of federated DME."""

    def __init__(self, cfg: ServiceConfig, anchor0=None, device=None):
        """``anchor0``: optional warm-start reference for round 1 (numpy or
        tensor); None starts from the zero anchor.  The state lives on
        ``device`` — the CUDA device unless the caller names another."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.round_id = 0               # last round OPENED
        self.published_id = 0           # last round PUBLISHED (in order)
        self.y = torch.full((cfg.nb,), cfg.y0, dtype=torch.float32,
                            device=self.device)
        self.anchor: Optional[torch.Tensor] = (
            None if anchor0 is None else rounds.as_f32(anchor0, self.device))
        self.anchor_round = 0           # round that produced self.anchor
        self.history: list[RoundStats] = []
        self._legacy: Optional[Round] = None

    # ------------------------------------------------------ LIFECYCLE API
    def open_round(self, now: float = 0.0,
                   max_pending: "int | None" = None) -> Round:
        """Open round k+1 against the CURRENT QState and return its Round.

        May be called while earlier rounds still seal/drain — the new round
        anchors against the latest *published* mean, and
        :attr:`Round.anchor_round` records the lag.  ``max_pending`` bounds
        the server's pending store (admission control)."""
        self.round_id += 1
        digest = (rounds.anchor_digest(self.anchor)
                  if self.cfg.anchored and self.anchor is not None else 0)
        y_buckets = tuple(self.y.tolist())      # one copy to the host
        spec = wire.RoundSpec(
            round_id=self.round_id, d=self.cfg.d, cfg=self.cfg.qcfg,
            y0=max(y_buckets),
            seed=rounds.fold_seed(self.cfg.seed, self.round_id),
            max_attempts=self.cfg.max_attempts,
            y_buckets=y_buckets,
            anchor_digest=digest, mtu=self.cfg.mtu,
            window=self.cfg.window)
        # anchored: decode in anchor-relative space.  Unanchored: the last
        # published mean still serves as the decode reference
        ref = (self.anchor if self.anchor is not None
               else torch.zeros((self.cfg.d,), dtype=torch.float32,
                                device=self.device))
        server = AggServer(spec, ref, max_pending=max_pending,
                           device=self.device)
        return Round(spec, ref, server, anchor_round=self.anchor_round,
                     opened_at=now)

    def publish_round(self, rnd: Round, now: float = 0.0
                      ) -> "tuple[torch.Tensor, RoundStats]":
        """Publish a round and advance the QState: anchor <- the round
        mean, y <- the per-bucket update from the round's decode telemetry.
        Rounds MUST publish in round-id order."""
        if rnd.round_id != self.published_id + 1:
            raise RuntimeError(
                f"round {rnd.round_id} published out of order (last "
                f"published {self.published_id})")
        mean, stats = rnd.publish(now)
        self.anchor = mean
        self.anchor_round = rnd.round_id
        self.y = QS.update_y(
            self.y, torch.from_numpy(stats.fails_b).to(self.device),
            torch.from_numpy(stats.dist_b).to(self.device),
            decay=self.cfg.y_decay, escalate=self.cfg.y_escalate,
            floor=self.cfg.y_floor)
        self.history.append(stats)
        self.published_id = rnd.round_id
        return mean, stats

    # ------------------------------------------- LOCKSTEP (one-round) API
    def begin_round(self) -> "tuple[wire.RoundSpec, Optional[torch.Tensor]]":
        """Open round k+1 lockstep-style: returns (spec, anchor or None)."""
        self._legacy = self.open_round()
        return self._legacy.spec, self._legacy.client_anchor

    def make_server(self) -> AggServer:
        """The open lockstep round's server."""
        assert self._legacy is not None, "begin_round() first"
        return self._legacy.server

    def end_round(self, server: AggServer
                  ) -> "tuple[torch.Tensor, RoundStats]":
        """Close the lockstep round: finalize, advance the QState."""
        assert self._legacy is not None, "begin_round() first"
        assert server is self._legacy.server, \
            "end_round() got a server from a different round"
        rnd, self._legacy = self._legacy, None
        return self.publish_round(rnd)
