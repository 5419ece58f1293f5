"""In-process federated-DME simulation: many clients, one server, failures;
counterpart of ``repro.agg.sim``.

Drives simulated clients through the port's aggregation endpoints over the
real byte protocol, with the failure modes a deployment sees: stragglers,
dropped clients, duplicate deliveries, corrupt and truncated frames,
out-of-bound inputs recovered by escalation (or dropped at the q cap) and,
with ``SimConfig.mtu > 0``, chunked transport (:func:`run_chunked_lossy`
pins the selective-retransmit wire cost byte for byte).
:func:`run_rounds` drives the multi-round anchored service over a drifting
population; :func:`run_open_loop` drives the continuous-round engine with
open-loop Poisson arrivals on a virtual clock and replays every published
round through a fresh lockstep server over exactly its accepted clients
(bit-identical means); :func:`run_lockstep` runs the same trace through
the one-round-at-a-time coordinator.

The traffic — vectors, arrival times, drops, duplicates, corruption, the
drifting population — is drawn with numpy's ``RandomState`` exactly as the
reference draws it, so the port and the reference see the same trace and
their published rounds can be compared bit for bit.  The aggregation runs
on the device the caller names (the CUDA device unless ``device="cpu"``).

The attempt-0 fleet is encoded in ONE launch of the fused encode
(:func:`fleet_encode` stacks all clients into one flat vector of
S x padded coordinates); retries go through the per-client
:class:`~repro_torch.agg.client.AggClient` path (bit-identical payloads).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np
import torch

import repro_torch.obs as _obs
from repro_torch import resolve_device
from repro_torch.agg import rounds
from repro_torch.agg.api import AggConfig
from repro_torch.agg.client import AggClient
from repro_torch.agg.engine import AggEngine, EngineConfig, PublishedRound
from repro_torch.agg.server import AggServer, RoundStats
from repro_torch.agg.service import AggService, ServiceConfig
from repro_torch.agg.transport import chunks as C
from repro_torch.agg.transport import frame as wire
from repro_torch.core import error_detect as ED
from repro_torch.core import lattice as L
from repro_torch.core import rotation as R
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.kernels import ops as K


@dataclasses.dataclass(frozen=True)
class SimConfig:
    clients: int = 512
    d: int = 1 << 12
    q: int = 16
    bucket: int = 512
    rotate: bool = False
    y0: float = 0.5
    spread: float = 0.02       # client noise scale around the base vector
    base_scale: float = 5.0
    drop: float = 0.02         # fraction of clients never delivered
    duplicate: float = 0.05    # fraction delivered twice
    straggle: float = 0.25     # fraction arriving after the first drain
    corrupt: int = 2           # extra deliveries with a flipped byte
    truncate: int = 1          # extra deliveries cut short
    adversarial: int = 4       # out-of-bound inputs recoverable by escalation
    extreme: int = 1           # beyond the q-cap margin: must be dropped
    max_attempts: int = 4
    seed: int = 0
    round_id: int = 1
    mtu: int = 0               # chunked transport when > 0 (bytes per chunk)

    def spec(self) -> wire.RoundSpec:
        return wire.RoundSpec(
            round_id=self.round_id, d=self.d,
            cfg=QSyncConfig(q=self.q, bucket=self.bucket, rotate=self.rotate),
            y0=self.y0, seed=self.seed, max_attempts=self.max_attempts,
            mtu=self.mtu)


@dataclasses.dataclass
class SimReport:
    stats: RoundStats
    mean: torch.Tensor            # (d,) f32 on the server's device
    expected: np.ndarray          # exact mean over the accepted clients
    max_err: float
    accepted_clients: frozenset
    escalated_clients: frozenset  # accepted only after >= 1 NACK
    dropped_clients: frozenset    # never delivered or escalation-exhausted
    drains: int
    bytes_per_client: float       # attempt-0 payload size incl. header


def fleet_encode(spec: wire.RoundSpec, xs, anchor=None, device=None
                 ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Encode all S clients' attempt-0 bodies in one fused kernel launch.

    Stacks the bucketized fleet into a single flat vector of S x padded
    coordinates (per-client word segments stay uint32-aligned because
    padded d is a multiple of the bucket size), encodes once — with the
    round anchor subtracted in the kernel for anchored rounds, and the
    per-bucket sides repeated per client rather than broadcast per
    coordinate — and splits words/checksums per client.  ``xs`` (S, d) and
    ``anchor`` may be numpy arrays or tensors; the work runs on ``device``
    (the CUDA device unless the caller names another).  Returns (words
    (S, nw) uint32, sides (nb,) f32, checks (S,) uint32), on the host.
    """
    rounds.check_anchor(spec, anchor)
    dev = resolve_device(device)
    xs = rounds.as_f32(xs, dev)
    S = xs.shape[0]
    pad = spec.padded - spec.d
    v = torch.nn.functional.pad(xs, (0, pad))
    v = v.reshape(S * spec.nb, spec.cfg.bucket)
    if spec.cfg.rotate:
        v = R.rotate(v, rounds.rotation_diag(spec, dev),
                     use_kernel=spec.cfg.packed)
    sides = rounds.sides(spec, dev)
    u = rounds.dither(spec, dev).reshape(-1)
    flat = v.reshape(-1)
    del v
    a_tiled = None
    if spec.anchored:
        a_flat = rounds.bucketize(rounds.as_f32(anchor, dev),
                                  spec).reshape(-1)
        a_tiled = a_flat.repeat(S)
        del a_flat
    words, k = K.lattice_encode(flat, u.repeat(S), sides.repeat(S),
                                q=spec.cfg.q, return_coords=True,
                                anchor=a_tiled, bucket=spec.cfg.bucket)
    del flat, a_tiled
    nw = L.packed_len(spec.padded, spec.cfg.bits)
    words = words.cpu().numpy().view(np.uint32).reshape(S, nw)
    weights = rounds.checksum_weights(spec, dev)
    checks = ED.coord_checksum(k.reshape(S, spec.padded), weights, axis=-1)
    return (words, sides.cpu().numpy(),
            checks.cpu().numpy().astype(np.uint32))


def fleet_frames(spec: wire.RoundSpec, xs, anchor=None,
                 device=None) -> "list[list[bytes]]":
    """Every client's attempt-0 chunk-frame sequence (one frame per client
    when the round is unchunked), bit-identical to AggClient.frames()."""
    words, sides_np, checks = fleet_encode(spec, xs, anchor, device)
    trace = _obs.tracing_enabled()
    out = []
    for i in range(xs.shape[0]):
        if trace:
            _obs.tracer().begin("encode",
                                key=("client", spec.round_id, i),
                                parent=("round", spec.round_id),
                                round=spec.round_id, client=i, attempt=0)
        fr = C.encode_chunks(spec, i, 0, spec.cfg.q, words[i], sides_np,
                             int(checks[i]))
        if trace:
            _obs.tracer().end(("client", spec.round_id, i), n_chunks=len(fr))
        out.append(fr)
    return out


def fleet_payloads(spec: wire.RoundSpec, xs, anchor=None,
                   device=None) -> list[bytes]:
    """Single-frame attempt-0 payloads (rounds whose body fits one frame).

    Refuses a spec whose MTU chunks the payload — a single frame would be
    silently REJECTed by every server (n_chunks mismatch); use
    :func:`fleet_frames`."""
    if spec.n_chunks() != 1:
        raise ValueError(
            f"spec chunks payloads into {spec.n_chunks()} frames at mtu "
            f"{spec.mtu}; use fleet_frames()")
    words, sides_np, checks = fleet_encode(spec, xs, anchor, device)
    trace = _obs.tracing_enabled()
    out = []
    for i in range(xs.shape[0]):
        if trace:
            _obs.tracer().begin("encode",
                                key=("client", spec.round_id, i),
                                parent=("round", spec.round_id),
                                round=spec.round_id, client=i, attempt=0)
        pl = wire.encode_payload(spec, i, 0, spec.cfg.q, words[i], sides_np,
                                 int(checks[i]))
        if trace:
            _obs.tracer().end(("client", spec.round_id, i), n_chunks=1)
        out.append(pl)
    return out


def run_round(cfg: SimConfig = SimConfig(), device=None) -> SimReport:
    """One full aggregation round under the configured failure mix, on
    ``device`` (the CUDA device unless the caller names another)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(cfg.seed)
    spec = cfg.spec()
    S, d = cfg.clients, cfg.d

    base = cfg.base_scale * rng.randn(d).astype(np.float32)
    xs = base[None] + cfg.spread * rng.randn(S, d).astype(np.float32)
    # adversarial tail: offsets past the attempt-0 margin (random signs so
    # the §6 rotation cannot concentrate them into one coordinate)
    adv = list(range(S - cfg.adversarial - cfg.extreme, S - cfg.extreme))
    for i in adv:
        xs[i] += (10.0 * cfg.y0
                  * rng.choice([-1.0, 1.0], d).astype(np.float32))
    extreme = list(range(S - cfg.extreme, S))
    for i in extreme:
        xs[i] += 1e6 * cfg.y0 * rng.choice([-1.0, 1.0], d).astype(np.float32)

    server = AggServer(spec, base, device=dev)
    frames = fleet_frames(spec, xs, device=dev)

    # delivery plan: drops / stragglers / duplicates over the benign fleet
    benign = [i for i in range(S) if i not in set(adv + extreme)]
    rng.shuffle(benign)
    n_drop = int(round(cfg.drop * S))
    dropped = set(benign[:n_drop])
    rest = [i for i in range(S) if i not in dropped]
    n_straggle = int(round(cfg.straggle * S))
    stragglers = set(x for x in benign[n_drop:n_drop + n_straggle])
    wave1 = [i for i in rest if i not in stragglers]
    rng.shuffle(wave1)
    dup = rng.choice(wave1, size=int(round(cfg.duplicate * S)),
                     replace=False) if wave1 else []

    def deliver(clients) -> None:
        """Chunk-interleaved delivery: chunk k of every client goes out
        before chunk k+1 of any (the arrival pattern a real fan-in sees);
        unchunked rounds degenerate to one frame per client."""
        k = 0
        while True:
            sent = False
            for i in clients:
                if k < len(frames[i]):
                    server.ingest_frame(frames[i][k])
                    sent = True
            if not sent:
                return
            k += 1

    def damaged(data: bytes, kind: str) -> bytes:
        if kind == "corrupt":
            b = bytearray(data)
            b[rng.randint(len(b))] ^= 0xFF
            return bytes(b)
        return data[: rng.randint(8, len(data) - 1)]

    def any_frame(i: int) -> bytes:
        return frames[i][rng.randint(len(frames[i]))]

    # wave 1: the bulk of the fleet, shuffled, plus damaged frames
    deliver(wave1)
    for _ in range(cfg.corrupt):
        server.ingest_frame(damaged(any_frame(rng.choice(wave1)), "corrupt"))
    for _ in range(cfg.truncate):
        server.ingest_frame(damaged(any_frame(rng.choice(wave1)), "truncate"))

    retry_clients: dict[int, AggClient] = {}
    escalated: set[int] = set()

    def route(responses: list[bytes]) -> list[bytes]:
        out = []
        for rb in responses:
            r = wire.decode_response(rb)
            if r.status not in (wire.STATUS_NACK, wire.STATUS_RESEND):
                continue
            c = retry_clients.setdefault(
                r.client_id, AggClient(spec, r.client_id, xs[r.client_id],
                                       device=dev))
            if r.status == wire.STATUS_NACK:
                escalated.add(r.client_id)
            out.extend(c.handle_response(rb))
        return out

    retries = route(server.tick())
    # wave 2: stragglers, duplicates and first-round escalation retries
    deliver(stragglers)
    for i in dup:
        for f in frames[i]:
            server.ingest_frame(f)
    for p in retries:
        server.ingest_frame(p)
    retries = route(server.tick())
    while retries:                         # escalation ladder, bounded by
        for p in retries:                  # max_attempts / the q cap
            server.ingest_frame(p)
        retries = route(server.tick())

    mean, stats = server.finalize()
    acc = sorted(server.accepted_clients)
    expected = (xs[acc].astype(np.float64).mean(0)
                if acc else np.zeros(d))
    max_err = (float(np.max(np.abs(mean.cpu().numpy() - expected)))
               if acc else 0.0)
    return SimReport(
        stats=stats, mean=mean, expected=expected.astype(np.float32),
        max_err=max_err, accepted_clients=frozenset(acc),
        escalated_clients=frozenset(escalated & set(acc)),
        dropped_clients=frozenset(set(range(S)) - set(acc)),
        drains=stats.drains,
        bytes_per_client=float(wire.payload_bytes(spec)))


# ---------------------------------------------------------------------------
# Lossy chunked transport: selective retransmit, byte-for-byte
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LossyReport:
    """Wire accounting of a chunked round that lost/corrupted chunks."""
    n_chunks_per_client: int
    bytes_clean: int           # client->server bytes of the lossless round
    bytes_total: int           # ... of the lossy round incl. retransmits
    retransmit_bytes: int      # RESEND-directed chunk frames only
    lost_frame_bytes: int      # the frames that were dropped/corrupted
    full_resend_bytes: int     # what v2 would have paid (whole payloads)
    mean: torch.Tensor
    mean_clean: torch.Tensor
    stats: RoundStats


def run_chunked_lossy(clients: int = 8, d: int = 4096, bucket: int = 512,
                      mtu: int = 512, n_drop: int = 2, n_corrupt: int = 1,
                      seed: int = 0, device=None) -> LossyReport:
    """One chunked round where individual chunks are dropped or corrupted.

    Asserts the tentpole's retransmit-cost contract: recovery costs exactly
    the lost chunks' frames on the wire (per-chunk NACK + selective
    retransmit) — never a full-payload resend — and the recovered round
    mean is bit-identical to the lossless round's.  Runs on ``device`` (the
    CUDA device unless the caller names another).
    """
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    spec = wire.RoundSpec(round_id=1, d=d,
                          cfg=QSyncConfig(q=16, bucket=bucket), y0=0.5,
                          seed=seed, mtu=mtu)
    base = rng.randn(d).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(clients, d).astype(np.float32)
    frames = fleet_frames(spec, xs, device=dev)
    nc = len(frames[0])
    assert nc >= 2, f"mtu {mtu} does not chunk a {spec.body_bytes()}B body"
    bytes_clean = sum(len(f) for fs in frames for f in fs)

    # the reference lossless round
    ref = AggServer(spec, base, device=dev)
    for fs in frames:
        for f in fs:
            ref.ingest_frame(f)
    mean_clean, _ = ref.finalize()

    # loss plan: distinct (client, chunk) victims; corrupt frames are
    # delivered damaged (same length), dropped frames never arrive
    victims = [(int(c), int(k)) for c, k in
               zip(rng.choice(clients, n_drop + n_corrupt, replace=False),
                   rng.randint(0, nc, n_drop + n_corrupt))]
    drop, corrupt = set(victims[:n_drop]), set(victims[n_drop:])
    lost_frame_bytes = sum(len(frames[c][k]) for c, k in drop | corrupt)

    server = AggServer(spec, base, device=dev)
    bytes_total = 0
    for k in range(nc):                     # chunk-interleaved fan-in
        for c in range(clients):
            f = frames[c][k]
            if (c, k) in drop:
                continue
            if (c, k) in corrupt:
                b = bytearray(f)
                b[rng.randint(len(b))] ^= 0xFF
                f = bytes(b)
            bytes_total += len(f)
            server.ingest_frame(f)

    # drain: complete clients decode; incomplete ones get chunk NACKs
    # naming exactly the missing indices
    retransmit_bytes = 0
    clients_obj: dict[int, AggClient] = {}
    resps = server.tick()
    while True:
        resend = []
        for rb in resps:
            r = wire.decode_response(rb)
            if r.status != wire.STATUS_RESEND:
                continue
            c = clients_obj.setdefault(
                r.client_id, AggClient(spec, r.client_id, xs[r.client_id],
                                       device=dev))
            out = c.handle_response(rb)
            assert [wire.decode_frame(f)[0].chunk_index for f in out] == \
                list(r.missing), "retransmit is not the missing set"
            resend.extend(out)
        if not resend:
            break
        for f in resend:
            retransmit_bytes += len(f)
            bytes_total += len(f)
            server.ingest_frame(f)
        resps = server.tick()

    mean, stats = server.finalize()
    affected = {c for c, _ in drop | corrupt}
    full_resend_bytes = len(affected) * sum(len(f) for f in frames[0])
    rep = LossyReport(
        n_chunks_per_client=nc, bytes_clean=bytes_clean,
        bytes_total=bytes_total, retransmit_bytes=retransmit_bytes,
        lost_frame_bytes=lost_frame_bytes,
        full_resend_bytes=full_resend_bytes, mean=mean,
        mean_clean=mean_clean, stats=stats)
    # the wire-byte contract: what recovery cost is exactly the lost
    # chunks' frames — and strictly less than v2's whole-payload resends
    assert rep.retransmit_bytes == rep.lost_frame_bytes, rep
    dropped_bytes = sum(len(frames[c][k]) for c, k in drop)
    assert rep.bytes_total == \
        rep.bytes_clean - dropped_bytes + rep.retransmit_bytes, rep
    assert rep.retransmit_bytes < rep.full_resend_bytes, rep
    assert stats.accepted == clients, stats
    assert torch.equal(rep.mean, rep.mean_clean), "chunked != lossless"
    return rep


# ---------------------------------------------------------------------------
# Multi-round simulation: drifting large-norm mean, anchored QState
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiRoundConfig:
    """A drifting population aggregated over several anchored rounds.

    Round k's population mean is ``mu_k = mu_{k-1} + drift_k`` with
    ``|mu| ~ norm_scale >> spread`` — exactly the regime where the paper's
    distance-dependent bounds beat input-norm-dependent schemes: the
    *movement* between rounds is small even though the mean itself is huge.
    ``concentrate`` shrinks the client spread each round (inputs
    concentrate), so the tracked per-bucket y — and with it the achievable
    MSE — tightens round over round.
    """
    clients: int = 256
    d: int = 1 << 12
    q: int = 16
    bucket: int = 512
    rounds: int = 8
    y0: float = 0.5
    norm_scale: float = 1e6    # |mu_0| scale (>> spread: the hard regime)
    drift: float = 0.05        # per-round movement of the mean
    spread0: float = 0.05      # round-0 client noise around the mean
    concentrate: float = 0.7   # spread multiplier per round (< 1: converge)
    anchored: bool = True
    mtu: int = 0               # chunked transport when > 0 (bytes per chunk)
    y_decay: float = 0.75
    seed: int = 0

    def agg_config(self) -> AggConfig:
        """Composed config; :func:`run_rounds` projects the service slice."""
        return AggConfig(d=self.d, q=self.q, bucket=self.bucket, y0=self.y0,
                         seed=self.seed, anchored=self.anchored,
                         mtu=self.mtu, y_decay=self.y_decay)


@dataclasses.dataclass
class RoundOutcome:
    round_id: int
    mse: float                 # vs the exact f64 population mean
    max_err: float
    accepted: int
    rejected: int
    decode_failures: int
    y_mean: float              # mean per-bucket bound entering the round
    bytes_per_client: float
    anchor_digest: int


def run_rounds(cfg: MultiRoundConfig = MultiRoundConfig(), device=None
               ) -> list[RoundOutcome]:
    """Drive the multi-round service over a drifting population.

    Every round: derive the spec from the service's QState (anchor = last
    round's mean, per-bucket y from telemetry), encode the fleet in one
    fused launch, stream payloads, finalize, advance the state.  Runs on
    ``device`` (the CUDA device unless the caller names another).
    """
    dev = resolve_device(device)
    rng = np.random.RandomState(cfg.seed)
    mu = cfg.norm_scale * rng.randn(cfg.d).astype(np.float32)
    # warm-start reference: deployments bootstrap round 1 from the known
    # previous model state (both the anchored and unanchored services get
    # the same head start — the comparison isolates encode-side anchoring)
    anchor0 = mu + (cfg.y0 / 4) * rng.randn(cfg.d).astype(np.float32)
    svc = AggService(cfg.agg_config().service_config(), anchor0=anchor0,
                     device=dev)
    outcomes = []
    spread = cfg.spread0
    for _ in range(cfg.rounds):
        mu = mu + cfg.drift * rng.randn(cfg.d).astype(np.float32)
        xs = mu[None] + spread * rng.randn(cfg.clients,
                                           cfg.d).astype(np.float32)
        spec, anchor = svc.begin_round()
        y_mean = float(np.mean(spec.y_np()))
        server = svc.make_server()
        frames = fleet_frames(spec, xs, anchor=anchor, device=dev)
        for i in rng.permutation(cfg.clients):
            for f in frames[i]:
                server.ingest_frame(f)
        # escalation ladder: route NACKs through the per-client protocol
        # object (q <- q^2, per-bucket granularity fixed) until quiescent
        retry_clients: dict[int, AggClient] = {}
        resps = server.tick()
        while True:
            retries = []
            for rb in resps:
                r = wire.decode_response(rb)
                if r.status not in (wire.STATUS_NACK, wire.STATUS_RESEND):
                    continue
                c = retry_clients.setdefault(
                    r.client_id,
                    AggClient(spec, r.client_id, xs[r.client_id],
                              anchor=anchor, device=dev))
                retries.extend(c.handle_response(rb))
            if not retries:
                break
            for p in retries:
                server.ingest_frame(p)
            resps = server.tick()
        mean, stats = svc.end_round(server)
        exact = xs.astype(np.float64).mean(0)
        err = np.abs(mean.cpu().numpy().astype(np.float64) - exact)
        outcomes.append(RoundOutcome(
            round_id=spec.round_id, mse=float(np.mean(err ** 2)),
            max_err=float(err.max()), accepted=stats.accepted,
            rejected=stats.rejected_spec + stats.rejected_wire,
            decode_failures=stats.decode_failures, y_mean=y_mean,
            bytes_per_client=float(wire.payload_bytes(spec)),
            anchor_digest=spec.anchor_digest))
        spread *= cfg.concentrate
    return outcomes


# ---------------------------------------------------------------------------
# Open-loop continuous rounds: Poisson arrivals driving the AggEngine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OpenLoopConfig:
    """Offered-load model + engine policy for the open-loop driver.

    Times are virtual seconds: the sim's clock is an event queue, so the
    latency/staleness/throughput metrics depend only on the trace and the
    policy — never on the machine running the sim.
    """
    d: int = 256
    q: int = 16
    bucket: int = 64
    y0: float = 0.5
    mtu: int = 64                  # small MTU: payloads chunk into ~3 frames
    window: int = 0                # per-client in-flight chunk cap (0:
                                   # blast; >0 turns on windowed send +
                                   # streaming decode, v5)
    max_attempts: int = 4
    # offered load
    rate: float = 250.0            # Poisson arrivals per virtual second
    duration: float = 0.5          # arrival window
    flash_at: "tuple[float, ...]" = (0.25,)   # flash-crowd instants
    flash_size: int = 32           # simultaneous arrivals per flash
    churn_frac: float = 0.06      # clients that vanish after one chunk
    straggle_frac: float = 0.12   # clients whose chunks trickle in late
    adversarial: int = 3          # out-of-bound inputs (escalate to recover)
    spread: float = 0.02
    base_scale: float = 2.0
    # network model
    net_delay: float = 0.004       # one-way frame latency scale
    straggle_delay: float = 0.12   # extra per-chunk delay for stragglers
    loss: float = 0.03             # per-frame loss probability
    nudge_delay: float = 0.06      # client-side full-resend timer (covers
                                   # the all-chunks-lost corner)
    # engine policy
    quorum: int = 24
    round_deadline: float = 0.08
    straggler_deadline: float = 0.04
    drain_deadline: float = 0.2
    max_resends: int = 2
    max_pending: "int | None" = None
    max_live_rounds: int = 4
    tick: float = 0.01             # advance() cadence between arrivals
    max_enrolls: int = 3           # per-client re-enrollment budget after
                                   # non-terminal RETRYs
    seed: int = 0

    def agg_config(self) -> AggConfig:
        """The composed knob surface; the layer configs are projections of
        this one object, so a knob cannot drift between service and engine."""
        return AggConfig(
            d=self.d, q=self.q, bucket=self.bucket, y0=self.y0,
            seed=self.seed, anchored=True, mtu=self.mtu,
            window=self.window, max_attempts=self.max_attempts,
            quorum=self.quorum, round_deadline=self.round_deadline,
            min_clients=1, straggler_deadline=self.straggler_deadline,
            max_resends=self.max_resends, drain_deadline=self.drain_deadline,
            max_pending=self.max_pending,
            max_live_rounds=self.max_live_rounds)

    def engine_config(self) -> EngineConfig:
        return self.agg_config().engine_config()

    def service_config(self) -> ServiceConfig:
        return self.agg_config().service_config()


@dataclasses.dataclass
class _Trace:
    """One offered-load realization, shared by the engine and lockstep
    drivers so their throughput is compared on identical traffic."""
    xs: np.ndarray                       # (N, d) client vectors by cid
    arrivals: "list[tuple[float, int]]"  # (t, cid), time-sorted
    straggler: frozenset
    churn: frozenset
    adversarial: frozenset


def _make_trace(cfg: OpenLoopConfig) -> _Trace:
    rng = np.random.RandomState(cfg.seed)
    times = []
    t = float(rng.exponential(1.0 / cfg.rate))
    while t < cfg.duration:
        times.append(t)
        t += float(rng.exponential(1.0 / cfg.rate))
    for t0 in cfg.flash_at:
        # a flash crowd: flash_size arrivals inside ~one network delay
        times.extend(t0 + cfg.net_delay * rng.rand(cfg.flash_size))
    times.sort()
    n = len(times)
    base = cfg.base_scale * rng.randn(cfg.d).astype(np.float32)
    xs = base[None] + cfg.spread * rng.randn(n, cfg.d).astype(np.float32)
    perm = rng.permutation(n)
    adv = frozenset(int(i) for i in perm[:cfg.adversarial])
    rest = [int(i) for i in perm[cfg.adversarial:]]
    n_churn = int(round(cfg.churn_frac * n))
    n_strag = int(round(cfg.straggle_frac * n))
    churn = frozenset(rest[:n_churn])
    strag = frozenset(rest[n_churn:n_churn + n_strag])
    for i in adv:
        # past the attempt-0 margin, recoverable by one escalation
        xs[i] += (10.0 * cfg.y0
                  * rng.choice([-1.0, 1.0], cfg.d).astype(np.float32))
    return _Trace(xs=xs, arrivals=[(float(t), i) for i, t in enumerate(times)],
                  straggler=strag, churn=churn, adversarial=adv)


@dataclasses.dataclass
class OpenLoopReport:
    """Virtual-clock outcome of one open-loop run (all times in virtual
    seconds — machine-independent, CI-gateable)."""
    rounds: int                   # rounds published
    clients_arrived: int
    accepted_total: int
    expired_total: int            # straggler-deadline expiries
    retried_total: int            # non-terminal RETRY responses clients saw
    resends_total: int            # STATUS_RESEND responses sent
    max_live_rounds: int          # peak concurrently-live rounds observed
    p50_latency: float            # open -> published round latency
    p99_latency: float
    mean_staleness: float         # anchor age at publish, averaged
    max_staleness_rounds: int     # worst anchor lag in rounds
    makespan: float               # first open -> last publish
    rounds_per_s: float
    window_stalls: int            # responses that unblocked no send while
                                  # chunks remained (windowed rounds only)
    published: "list[PublishedRound]"


def replay_published_round(trace: _Trace, pr: PublishedRound
                           ) -> torch.Tensor:
    """Re-aggregate a published round lockstep-style over EXACTLY its
    accepted clients (sorted ids, in-order chunks, no loss), on the device
    of its mean, and assert the mean is bit-identical — the engine's
    arrival order, chunk interleaving, loss pattern and overlapping-round
    interleaving provably did not move the published mean."""
    dev = pr.mean.device
    ref = (pr.anchor if pr.anchor is not None
           else torch.zeros((pr.spec.d,), dtype=torch.float32, device=dev))
    # streaming forced OFF: a windowed engine round is checked against the
    # SEALED batched-decode drain, not against another streaming server
    server = AggServer(pr.spec, ref, streaming=False, device=dev)
    clis = {}
    for cid in sorted(pr.accepted):
        c = AggClient(pr.spec, cid, trace.xs[cid], anchor=pr.anchor,
                      device=dev)
        clis[cid] = c
        for f in c.frames():
            server.ingest_frame(f)
    resps = server.tick()
    while True:
        retries = []
        for rb in resps:
            r = wire.decode_response(rb)
            if r.status not in (wire.STATUS_NACK, wire.STATUS_RESEND):
                continue
            retries.extend(clis[r.client_id].handle_response(rb))
        if not retries:
            break
        for f in retries:
            server.ingest_frame(f)
        resps = server.tick()
    mean, _ = server.finalize()
    assert server.accepted_clients == pr.accepted, \
        (server.accepted_clients, pr.accepted)
    assert torch.equal(mean, pr.mean), \
        f"round {pr.round_id}: engine mean != lockstep replay"
    return mean


def run_open_loop(cfg: OpenLoopConfig = OpenLoopConfig(),
                  check_parity: bool = True, device=None) -> OpenLoopReport:
    """Drive the continuous-round engine with open-loop Poisson arrivals.

    Clients enroll against whatever round is open when they arrive, their
    chunk frames travel with per-frame delays (stragglers trickle), frames
    are lost at the configured rate, and every response is routed back to
    the sender's protocol object — NACK escalation, selective retransmit
    and non-terminal RETRY re-enrollment all run over the real bytes.  The
    engine's cutover/straggler/publish policy fires purely off event
    times.  Asserts, for every published round, bit-identical replay
    parity, and that no benign client ever drew a terminal verdict.  Runs
    on ``device`` (the CUDA device unless the caller names another).
    """
    dev = resolve_device(device)
    trace = _make_trace(cfg)
    svc = AggService(cfg.service_config(), device=dev)
    eng = AggEngine(svc, cfg.engine_config(), now=0.0)
    rng = np.random.RandomState(cfg.seed + 1)
    heap: list = []
    seq = itertools.count()

    def push(t: float, kind: str, data) -> None:
        heapq.heappush(heap, (t, next(seq), kind, data))

    for t, cid in trace.arrivals:
        push(t, "enroll", cid)
    last_arrival = trace.arrivals[-1][0]
    horizon = (last_arrival + cfg.round_deadline + cfg.drain_deadline
               + cfg.straggler_deadline * (cfg.max_resends + 2) + 0.2)
    k = 1
    while k * cfg.tick < horizon:           # bounded tick train: advance()
        push(k * cfg.tick, "tick", None)    # fires even in arrival gaps
        k += 1

    active: "dict[int, AggClient]" = {}
    enrolls: "dict[int, int]" = {}
    retried_seen = 0
    benign_rejects = 0

    def send_frames(t: float, cid: int, frs: "list[bytes]") -> None:
        extra = cfg.straggle_delay if cid in trace.straggler else 0.0
        for kf, f in enumerate(frs):
            dt = cfg.net_delay * (0.5 + rng.rand()) + extra * (kf + rng.rand())
            push(t + dt, "frame", f)

    def enroll(t: float, cid: int) -> None:
        if enrolls.get(cid, 0) >= cfg.max_enrolls:
            return
        enrolls[cid] = enrolls.get(cid, 0) + 1
        rnd = eng.open_round
        c = AggClient(rnd.spec, cid, trace.xs[cid], anchor=rnd.client_anchor,
                      device=dev)
        active[cid] = c
        # windowed rounds: only the first credit-limited burst goes out
        # now; the rest rides the ack path in route() (blast when window=0)
        frs = c.send_frames()
        if cid in trace.churn:
            frs = frs[:1]                   # vanish after the first chunk
        send_frames(t, cid, frs)
        if cid not in trace.churn:
            push(t + cfg.nudge_delay, "nudge", cid)

    def route(t: float, resps: "list[bytes]") -> None:
        nonlocal retried_seen, benign_rejects
        for rb in resps:
            r = wire.decode_response(rb)
            c = active.get(r.client_id)
            if c is None or r.round_id != c.spec.round_id:
                continue                    # stale round: client moved on
            if r.client_id in trace.churn:
                continue                    # churned: never responds
            if r.status == wire.STATUS_RETRY:
                retried_seen += 1
            if (r.status == wire.STATUS_REJECT
                    and r.client_id not in trace.adversarial):
                benign_rejects += 1
            out = c.handle_response(rb)
            if out:
                send_frames(t, r.client_id, out)
            if c.retry_round is not None:
                # non-terminal admission verdict: back off one tick, then
                # re-enroll wherever admission is open by then
                c.retry_round = None
                push(t + cfg.tick, "enroll", r.client_id)

    t_last = 0.0
    while heap:
        t, _, kind, data = heapq.heappop(heap)
        t_last = max(t_last, t)
        if _obs.tracing_enabled():
            _obs.tracer().feed_time(t)   # virtual sim clock drives spans
        if kind == "enroll":
            enroll(t, data)
        elif kind == "frame":
            if rng.rand() < cfg.loss:
                continue                    # lost on the wire
            route(t, eng.ingest_frame(data, t))
        elif kind == "tick":
            route(t, eng.tick(t))
        elif kind == "nudge":
            c = active.get(data)
            if (c is not None and not c.acked and not c.gave_up
                    and c.retry_round is None):
                # timeout recovery: the unacked in-flight window (windowed
                # rounds — the all-copies-lost corner where the server has
                # no stream to RESEND from) or the full sequence (blast)
                send_frames(t, data, c.retransmit_frames())
                if c.spec.window and t + cfg.nudge_delay < horizon:
                    push(t + cfg.nudge_delay, "nudge", data)
    t_end = max(horizon, t_last) + cfg.tick
    eng.tick(t_end)
    eng.flush(t_end)

    assert benign_rejects == 0, \
        f"{benign_rejects} terminal verdicts reached benign clients"
    for cid, c in active.items():
        if cid not in trace.adversarial:
            assert not c.gave_up, f"benign client {cid} gave up"
    if check_parity:
        for pr in eng.published:
            replay_published_round(trace, pr)

    pubs = eng.published
    lat_h = _obs.Histogram.from_values(
        [pr.latency for pr in pubs] or [0.0])
    stale = np.array([pr.staleness for pr in pubs]) if pubs else np.zeros(1)
    makespan = (pubs[-1].published_at - pubs[0].opened_at) if pubs else 0.0
    return OpenLoopReport(
        rounds=len(pubs), clients_arrived=len(trace.arrivals),
        accepted_total=sum(len(pr.accepted) for pr in pubs),
        expired_total=sum(pr.stats.expired for pr in pubs),
        retried_total=(retried_seen
                       + sum(pr.stats.retried for pr in pubs)),
        resends_total=sum(pr.stats.resends_sent for pr in pubs),
        max_live_rounds=eng.max_live_seen,
        p50_latency=float(lat_h.quantile(50)),
        p99_latency=float(lat_h.quantile(99)),
        mean_staleness=float(stale.mean()),
        max_staleness_rounds=max((pr.staleness_rounds for pr in pubs),
                                 default=0),
        makespan=float(makespan),
        rounds_per_s=(len(pubs) / makespan if makespan > 0 else 0.0),
        window_stalls=sum(c.window_stalls for c in active.values()),
        published=pubs)


@dataclasses.dataclass
class LockstepReport:
    """The same offered load through the one-round-at-a-time coordinator."""
    rounds: int
    makespan: float
    rounds_per_s: float
    mean_round_time: float
    queue_delay_max: float     # worst arrival-to-admission wait


def run_lockstep(cfg: OpenLoopConfig = OpenLoopConfig(),
                 device=None) -> LockstepReport:
    """The lockstep baseline over the SAME arrival trace, same policy knobs.

    One round at a time: while round k drains, arrivals QUEUE — nobody can
    enroll until k publishes (the structural cost the engine's overlapping
    intake removes).  The round seals at quorum-or-deadline like the
    engine, but then must wait for its slowest enrolled client — a churned
    client costs the full ``drain_deadline`` timeout with every other
    client's admission blocked behind it.  Aggregation itself runs the real
    byte protocol (lossless in-order delivery; delivery *times* model the
    same per-chunk network delays as the open-loop driver), so the two
    drivers' rounds/sec differ by coordination structure only.  Runs on
    ``device`` (the CUDA device unless the caller names another).
    """
    dev = resolve_device(device)
    trace = _make_trace(cfg)
    svc = AggService(cfg.service_config(), device=dev)
    arrivals = trace.arrivals
    n = len(arrivals)
    t_of = {cid: t for t, cid in arrivals}
    i = 0
    t = 0.0
    round_times: "list[float]" = []
    queue_delay_max = 0.0
    nf = None
    while i < n:
        t_open = max(t, arrivals[i][0])
        roster = []
        j = i
        while (j < n and len(roster) < cfg.quorum
               and arrivals[j][0] <= t_open + cfg.round_deadline):
            roster.append(arrivals[j][1])
            j += 1
        t_seal = (max(t_open, arrivals[j - 1][0]) if len(roster) == cfg.quorum
                  else t_open + cfg.round_deadline)
        spec, anchor = svc.begin_round()
        server = svc.make_server()
        if nf is None:
            nf = spec.n_chunks()
        # virtual drain time: every enrolled client must land (or time out)
        t_drain = t_seal
        for cid in roster:
            queue_delay_max = max(queue_delay_max, t_open - t_of[cid])
            if cid in trace.churn:
                done = t_seal + cfg.drain_deadline     # waited out in full
            else:
                done = t_of[cid] + nf * cfg.net_delay
                if cid in trace.straggler:
                    done += nf * cfg.straggle_delay
                if cid in trace.adversarial:
                    # one escalation handshake: NACK out, full resend back
                    done += 2 * cfg.net_delay + nf * cfg.net_delay
                done = min(done, t_seal + cfg.drain_deadline)
            t_drain = max(t_drain, done)
        # the actual aggregation (instantaneous on the virtual clock —
        # compute cost is measured separately, in wall time, by the bench)
        clis: "dict[int, AggClient]" = {}
        for cid in sorted(roster):
            if cid in trace.churn:
                continue
            c = AggClient(spec, cid, trace.xs[cid], anchor=anchor,
                          device=dev)
            clis[cid] = c
            for f in c.frames():
                server.ingest_frame(f)
        resps = server.tick()
        while True:
            retries = []
            for rb in resps:
                r = wire.decode_response(rb)
                if r.status not in (wire.STATUS_NACK, wire.STATUS_RESEND):
                    continue
                retries.extend(clis[r.client_id].handle_response(rb))
            if not retries:
                break
            for f in retries:
                server.ingest_frame(f)
            resps = server.tick()
        svc.end_round(server)
        round_times.append(t_drain - t_open)
        t = t_drain
        i = j
    makespan = t - arrivals[0][0] if round_times else 0.0
    return LockstepReport(
        rounds=len(round_times), makespan=float(makespan),
        rounds_per_s=(len(round_times) / makespan if makespan > 0 else 0.0),
        mean_round_time=float(np.mean(round_times)) if round_times else 0.0,
        queue_delay_max=float(queue_delay_max))
