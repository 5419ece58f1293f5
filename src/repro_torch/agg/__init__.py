"""repro_torch.agg — streaming federated-DME aggregation on the packed
lattice wire; counterpart of ``repro.agg``.

Many clients ship compressed vectors to a coordinator that estimates their
mean, over a request/response protocol of real ``bytes``:

* :mod:`repro_torch.agg.transport` — the layered transport stack:
  ``frame`` (self-describing header + per-frame CRC + the RoundSpec
  contract), ``chunks`` (fixed-MTU splitting, selective retransmit),
  ``session`` (out-of-order, duplicate-tolerant reassembly);
* :mod:`repro_torch.agg.api` — the :class:`AggNode` protocol
  (``ingest_frame`` / ``tick`` / ``published``) every endpoint implements,
  and the one composed :class:`AggConfig` knob surface;
* :mod:`repro_torch.agg.client` — encodes a local vector against a round's
  shared randomness (one launch of the fused encode kernel), chunks it and
  handles escalation and selective-retransmit responses;
* :mod:`repro_torch.agg.server` — streaming accumulator: validates and
  reassembles frames, drains payloads through ONE batched decode launch
  per color space, sums in integer coordinate space (bit-deterministic
  under any arrival order), NACKs undecodable clients with an escalated
  bound;
* :mod:`repro_torch.agg.service` — multi-round coordinator: round k+1's
  anchor is round k's published mean (digest-pinned in the RoundSpec) and
  its per-bucket y comes from round k's decode telemetry
  (:func:`repro_torch.core.qstate.update_y`), plus the round life-cycle
  state machine (OPEN -> SEALING -> DRAINED -> PUBLISHED);
* :mod:`repro_torch.agg.engine` — the event-driven continuous-round loop
  over the service: several live rounds, quorum-or-deadline cutover,
  straggler deadlines feeding the RESEND budget, and admission control via
  non-terminal ``STATUS_RETRY``;
* :mod:`repro_torch.agg.tree` — the hierarchical sum-without-decode tree:
  tiers fold their children's integer residuals on the device and forward
  one combined payload; the root decodes once per color space;
* :mod:`repro_torch.agg.sim` — in-process harness driving simulated
  clients with stragglers, drops, duplicates, corruption, out-of-bound
  inputs and chunk loss; :func:`repro_torch.agg.sim.run_rounds` drives the
  multi-round service, :func:`repro_torch.agg.sim.run_open_loop` the
  engine.

Every endpoint runs on the CUDA device unless the caller passes
``device="cpu"``.
"""
from repro_torch.agg.transport import (RoundSpec, FrameHeader, Payload,
                                       Response, WireError,
                                       TruncatedPayloadError, BadMagicError,
                                       VersionMismatchError,
                                       CorruptPayloadError,
                                       HeaderMismatchError, encode_payload,
                                       decode_payload, encode_frame,
                                       decode_frame, encode_response,
                                       decode_response, q_at_attempt,
                                       y_at_attempt, y_buckets_at_attempt,
                                       payload_bytes, STATUS_QUEUED,
                                       STATUS_NACK, STATUS_REJECT, STATUS_ACK,
                                       STATUS_RESEND, STATUS_RETRY,
                                       peek_route, Reassembler,
                                       ReassemblyStats)
from repro_torch.agg.api import (AggConfig, AggNode, PublishedLog,
                                 PublishedRound)
from repro_torch.agg.client import AggClient
from repro_torch.agg.server import AggServer, RoundStats
from repro_torch.agg.service import (AggService, Round, RoundState,
                                     ServiceConfig)
from repro_torch.agg.engine import AggEngine, EngineConfig
from repro_torch.agg.tree import AggTree, TierAggregator, TierStats

__all__ = [
    "RoundSpec", "FrameHeader", "Payload", "Response", "WireError",
    "TruncatedPayloadError", "BadMagicError", "VersionMismatchError",
    "CorruptPayloadError", "HeaderMismatchError", "encode_payload",
    "decode_payload", "encode_frame", "decode_frame", "encode_response",
    "decode_response", "q_at_attempt", "y_at_attempt",
    "y_buckets_at_attempt", "payload_bytes", "AggClient", "AggServer",
    "RoundStats", "AggService", "Round", "RoundState", "ServiceConfig",
    "AggEngine", "EngineConfig", "PublishedRound", "Reassembler",
    "ReassemblyStats", "STATUS_QUEUED", "STATUS_NACK", "STATUS_REJECT",
    "STATUS_ACK", "STATUS_RESEND", "STATUS_RETRY", "peek_route",
    "AggConfig", "AggNode", "PublishedLog", "AggTree", "TierAggregator",
    "TierStats",
]
