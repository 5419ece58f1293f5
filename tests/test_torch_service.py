"""The multi-round service, AggConfig, the sim's rounds and the port's
repairs: repro_torch.agg vs repro.agg on the CPU.

The same numpy-seeded anchors, populations and fleets go to both packages
(the port with ``device="cpu"``).  Specs, frames, accepted sets, the
per-bucket ``y`` after each round, anchor digests, published means and
wire bytes are held bitwise.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.agg import rounds as JR
from repro.agg import sim as JS
from repro.agg.api import AggConfig as JAggConfig
from repro.agg.client import AggClient as JClient
from repro.agg.service import AggService as JService
from repro.agg.service import ServiceConfig as JServiceConfig
from repro.agg.transport import frame as Jw
from repro.dist.collectives import QSyncConfig as JQ
from repro_torch import convert
from repro_torch.agg import rounds as TRd
from repro_torch.agg import sim as TS
from repro_torch.agg.api import AggConfig
from repro_torch.agg.client import AggClient as TClient
from repro_torch.agg.engine import EngineConfig
from repro_torch.agg.service import AggService, RoundState, ServiceConfig
from repro_torch.agg.transport import frame as Tw
from repro_torch.dist.collectives import QSyncConfig as TQ

ROOT = Path(__file__).resolve().parents[1]


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.asarray(a, np.float32).view(np.uint32)


def _spec_fields(spec):
    f = dataclasses.asdict(spec)
    f["cfg"] = dataclasses.asdict(spec.cfg)
    return f


def _escalate(server, clients, resps):
    """Route NACK / RESEND responses through the clients until quiescent
    (the sim's escalation ladder)."""
    while True:
        retries = []
        for rb in resps:
            r = Jw.decode_response(rb)
            if r.status in (Jw.STATUS_NACK, Jw.STATUS_RESEND):
                retries.extend(clients[r.client_id].handle_response(rb))
        if not retries:
            return
        for f in retries:
            server.ingest_frame(f)
        resps = server.tick()


# ---------------------------------------------------------------------------
# The anchored chain, port vs reference
# ---------------------------------------------------------------------------

def test_service_anchor_chain_matches_reference():
    """Three anchored rounds of a drifting population (one client out of
    bound in round 2, so it escalates): every round's spec (digest,
    seed, per-bucket y), frames, accepted set, mean and the ``y`` it leaves
    behind equal the reference's bit for bit, and round k+1's digest is
    that of round k's mean."""
    d, bucket, n = 512, 64, 5
    rng = np.random.RandomState(0)
    anchor0 = np.zeros(d, np.float32)
    kw = dict(d=d, bucket=bucket, y0=1.0, seed=7)
    jsvc = JService(JServiceConfig(**kw), anchor0=anchor0)
    tsvc = AggService(ServiceConfig(**kw), anchor0=anchor0, device="cpu")
    mu = 0.2 * rng.randn(d).astype(np.float32)
    prev = None
    for r in range(3):
        mu = mu + 0.05 * rng.randn(d).astype(np.float32)
        xs = mu[None] + 0.1 * rng.randn(n, d).astype(np.float32)
        if r == 1:
            xs[3, :bucket] += 8.0          # out of bound in bucket 0 only
        jspec, janchor = jsvc.begin_round()
        tspec, tanchor = tsvc.begin_round()
        assert _spec_fields(tspec) == _spec_fields(jspec)
        assert isinstance(tanchor, torch.Tensor)
        np.testing.assert_array_equal(_bits(tanchor), _bits(janchor))
        if prev is not None:
            assert tspec.anchor_digest == TRd.anchor_digest(prev) != 0
        jframes = JS.fleet_payloads(jspec, xs, anchor=janchor)
        tframes = TS.fleet_payloads(tspec, xs, anchor=tanchor, device="cpu")
        assert tframes == jframes
        out = []
        for svc, frames, mk in (
                (jsvc, jframes, lambda i: JClient(jspec, i, xs[i],
                                                  anchor=janchor)),
                (tsvc, tframes, lambda i: TClient(tspec, i, xs[i],
                                                  anchor=tanchor,
                                                  device="cpu"))):
            server = svc.make_server()
            for f in frames:
                server.ingest_frame(f)
            _escalate(server, {i: mk(i) for i in range(n)}, server.tick())
            accepted = server.accepted_clients
            mean, stats = svc.end_round(server)
            out.append((accepted, mean, stats))
        (ja, jmean, jst), (ta, tmean, tst) = out
        assert ta == ja == frozenset(range(n))
        assert isinstance(tmean, torch.Tensor) and tmean.device.type == "cpu"
        np.testing.assert_array_equal(_bits(tmean), _bits(jmean))
        np.testing.assert_array_equal(tst.fails_b, jst.fails_b)
        np.testing.assert_array_equal(tst.dist_b, jst.dist_b)
        assert tst.nacks_sent == jst.nacks_sent == (1 if r == 1 else 0)
        assert tsvc.y.dtype == torch.float32 and tsvc.y.device.type == "cpu"
        np.testing.assert_array_equal(_bits(tsvc.y), _bits(jsvc.y))
        assert tsvc.anchor is tmean and tsvc.anchor_round == r + 1
        prev = tmean


def test_run_rounds_matches_reference():
    """``sim.run_rounds`` (the drifting large-norm population, fleet encode,
    escalation ladder) yields the reference's outcomes exactly: MSE and
    max error (so the means), digests, accepts and the tracked y."""
    kw = dict(clients=32, d=1024, bucket=128, rounds=4, norm_scale=1e6,
              y0=0.5, spread0=0.05, concentrate=0.7, seed=0)
    for anchored in (True, False):
        jo = JS.run_rounds(JS.MultiRoundConfig(anchored=anchored, **kw))
        to = TS.run_rounds(TS.MultiRoundConfig(anchored=anchored, **kw),
                           device="cpu")
        assert [dataclasses.asdict(o) for o in to] == \
            [dataclasses.asdict(o) for o in jo]
        assert all(o.accepted == kw["clients"] for o in to)


# ---------------------------------------------------------------------------
# State machine guards and in-order publishing
# ---------------------------------------------------------------------------

def _svc(**kw):
    base = dict(d=256, bucket=64, y0=1.0, seed=3, anchored=True)
    base.update(kw)
    return AggService(ServiceConfig(**base), device="cpu")


def test_round_state_machine_guards():
    svc = _svc()
    rnd = svc.open_round()
    assert rnd.state is RoundState.OPEN
    with pytest.raises(RuntimeError, match="illegal transition"):
        rnd.mark_drained()
    rnd.seal(now=1.0, next_round_id=2)
    assert rnd.state is RoundState.SEALING and rnd.server.sealed
    with pytest.raises(RuntimeError, match="illegal transition"):
        rnd.seal()
    rnd.mark_drained(now=2.0)
    mean, stats = rnd.publish(now=3.0)
    assert rnd.state is RoundState.PUBLISHED
    m2, _ = rnd.publish(now=9.0)            # idempotent, timestamps keep
    assert m2 is mean and rnd.published_at == 3.0
    # publish() from SEALING drains, then expires; mark_drained refuses
    rnd = svc.open_round()
    x = 0.1 * np.random.RandomState(0).randn(256).astype(np.float32)
    rnd.server.receive(TClient(rnd.spec, 7, x, anchor=rnd.client_anchor,
                               device="cpu").frames()[0])
    rnd.seal()
    with pytest.raises(RuntimeError, match="unresolved"):
        rnd.mark_drained()
    rnd.publish()
    assert rnd.server.accepted_clients == frozenset({7})


def test_service_rejects_out_of_order_publish():
    svc = _svc()
    r1, r2 = svc.open_round(), svc.open_round()
    assert (r1.round_id, r2.round_id) == (1, 2)
    assert r2.anchor_round == 0
    with pytest.raises(RuntimeError, match="out of order"):
        svc.publish_round(r2)
    svc.publish_round(r1)
    svc.publish_round(r2)
    assert svc.published_id == 2
    assert svc.open_round().anchor_round == 2
    svc.begin_round()
    with pytest.raises(AssertionError, match="different round"):
        svc.end_round(r1.server)


# ---------------------------------------------------------------------------
# AggConfig
# ---------------------------------------------------------------------------

def test_agg_config_defaults_match_reference_and_layers():
    """AggConfig's fields and defaults equal the reference's one by one,
    and equal the port's ServiceConfig / EngineConfig; the projections
    carry every mirrored field across."""
    def defaults(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.default is not dataclasses.MISSING}

    assert [f.name for f in dataclasses.fields(AggConfig)] == \
        [f.name for f in dataclasses.fields(JAggConfig)]
    assert defaults(AggConfig) == defaults(JAggConfig)
    assert AggConfig._SERVICE_FIELDS == JAggConfig._SERVICE_FIELDS
    assert AggConfig._ENGINE_FIELDS == JAggConfig._ENGINE_FIELDS
    agg, svc, eng = (defaults(AggConfig), defaults(ServiceConfig),
                     defaults(EngineConfig))
    for name in AggConfig._SERVICE_FIELDS:
        if name in svc:
            assert agg[name] == svc[name], name
    for name in AggConfig._ENGINE_FIELDS:
        assert agg[name] == eng[name], name
    cfg = AggConfig(d=512, q=64, window=2, quorum=9, max_pending=3)
    sc, ec = cfg.service_config(), cfg.engine_config()
    assert isinstance(sc, ServiceConfig) and isinstance(ec, EngineConfig)
    for name in AggConfig._SERVICE_FIELDS:
        assert getattr(sc, name) == getattr(cfg, name), name
    for name in AggConfig._ENGINE_FIELDS:
        assert getattr(ec, name) == getattr(cfg, name), name


# ---------------------------------------------------------------------------
# The sim's single rounds
# ---------------------------------------------------------------------------

def test_run_round_matches_reference():
    """``sim.run_round`` at the reference test's size (512 clients,
    d = 4096): drops, duplicates, stragglers, corrupt and truncated frames,
    escalation and the q-cap drop give the reference's accepted and
    escalated sets, telemetry and mean bit for bit."""
    cfg = dict(clients=512, d=4096, bucket=512, drop=0.02, duplicate=0.05,
               straggle=0.25, corrupt=2, truncate=1, adversarial=4,
               extreme=1, seed=0)
    jr = JS.run_round(JS.SimConfig(**cfg))
    tr = TS.run_round(TS.SimConfig(**cfg), device="cpu")
    assert tr.accepted_clients == jr.accepted_clients
    assert tr.escalated_clients == jr.escalated_clients
    assert len(tr.escalated_clients) == 4
    assert tr.dropped_clients == jr.dropped_clients
    np.testing.assert_array_equal(_bits(tr.mean), _bits(jr.mean))
    np.testing.assert_array_equal(tr.expected, jr.expected)
    assert tr.max_err == jr.max_err <= 2 * 0.5
    js, ts = dataclasses.asdict(jr.stats), dataclasses.asdict(tr.stats)
    for k in ("dist_b", "fails_b"):
        np.testing.assert_array_equal(ts.pop(k), js.pop(k))
    assert ts == js
    assert tr.bytes_per_client == jr.bytes_per_client


def test_run_chunked_lossy_wire_bytes_match_reference():
    jr = JS.run_chunked_lossy()
    tr = TS.run_chunked_lossy(device="cpu")
    for k in ("n_chunks_per_client", "bytes_clean", "bytes_total",
              "retransmit_bytes", "lost_frame_bytes", "full_resend_bytes"):
        assert getattr(tr, k) == getattr(jr, k), k
    assert tr.retransmit_bytes == tr.lost_frame_bytes > 0
    np.testing.assert_array_equal(_bits(tr.mean), _bits(jr.mean))


@pytest.mark.parametrize("rotate,anchored", [(False, False), (False, True),
                                             (True, False)])
def test_fleet_encode_equals_separate_client_encodes(rotate, anchored):
    """One encode launch over 16 x padded coordinates gives each client's
    frame byte for byte as its own AggClient does, and as the reference's
    fleet encoder does (unrotated)."""
    d, S = 1000, 16
    rng = np.random.RandomState(4)
    base = rng.randn(d).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(S, d).astype(np.float32)
    anchor = base if anchored else None
    js = Jw.RoundSpec(round_id=2, d=d,
                      cfg=JQ(q=16, bucket=128, rotate=rotate),
                      y0=0.5, seed=5,
                      anchor_digest=JR.anchor_digest(anchor)
                      if anchored else 0)
    ts = convert.round_spec(dataclasses.asdict(js))
    fleet = TS.fleet_payloads(ts, xs, anchor=anchor, device="cpu")
    for i in range(S):
        assert TClient(ts, i, xs[i], anchor=anchor,
                       device="cpu").payload() == fleet[i]
    if not rotate:
        assert fleet == JS.fleet_payloads(js, xs, anchor=anchor)
    with pytest.raises(ValueError, match="use fleet_frames"):
        TS.fleet_payloads(dataclasses.replace(ts, mtu=64), xs[:2],
                          anchor=anchor, device="cpu")


def test_encode_launch_takes_a_fleet_past_2_31_and_refuses_past_its_grid():
    """The fleet encoder hands the encode kernel S x padded coordinates in
    one launch; the kernel's persistent grid strides over runs with int64
    indices, so its wrapper takes n past 2^31 and refuses only what would
    overflow its byte offsets (checked before any pointer is touched, on
    meta tensors)."""
    from repro_torch.kernels import lattice_encode as LE

    assert LE.MAX_N > 8 * 277_848_064 > 1 << 31
    big = torch.empty(LE.MAX_N + 32, device="meta")
    with pytest.raises(ValueError, match="at most"):
        LE.lattice_encode_cuda(big, big, 0.1, q=16)


# ---------------------------------------------------------------------------
# Repairs: device defaults, package exports, the published anchor
# ---------------------------------------------------------------------------

def _device_helpers():
    from repro_torch import random as R
    from repro_torch.core import error_detect as ED
    from repro_torch.core import lattice as L
    from repro_torch.core import rotation as Rot

    key = R.PRNGKey(3)
    spec = Tw.RoundSpec(round_id=1, d=300, cfg=TQ(q=16, bucket=64),
                        y0=0.5, seed=2)
    return {
        "random.bits": (lambda **kw: R.bits(key, (40,), **kw)),
        "random.uniform": (lambda **kw: R.uniform(key, (40,), **kw)),
        "random.rademacher": (lambda **kw: R.rademacher(key, (40,), **kw)),
        "random.randint": (lambda **kw: R.randint(key, (40,), 0, 9, **kw)),
        "random.permutation": (lambda **kw: R.permutation(key, 40, **kw)),
        "random.normal": (lambda **kw: R.normal(key, (40,), **kw)),
        "lattice.shared_offset": (
            lambda **kw: L.shared_offset(key, (40,), **kw)),
        "rotation.rademacher_diag": (
            lambda **kw: Rot.rademacher_diag(key, 40, **kw)),
        "rotation.rotation_keypair": (
            lambda **kw: Rot.rotation_keypair(key, 40, **kw)),
        "error_detect.checksum_weights": (
            lambda **kw: ED.checksum_weights(key, 40, **kw)),
        "rounds.dither": (lambda **kw: TRd.dither(spec, **kw)),
        "rounds.checksum_weights": (
            lambda **kw: TRd.checksum_weights(spec, **kw)),
        "rounds.rotation_diag": (lambda **kw: TRd.rotation_diag(spec, **kw)),
        "rounds.sides": (lambda **kw: TRd.sides(spec, **kw)),
        "rounds.decode_ref_coords": (
            lambda **kw: TRd.decode_ref_coords(spec, **kw)),
    }


_HELPERS = sorted(_device_helpers())


@pytest.mark.parametrize("name", _HELPERS)
def test_helpers_run_on_the_card_unless_asked(name, monkeypatch):
    """Each random and round-state helper goes through ``resolve_device``:
    with no card and no device named it raises; asked for the CPU it gives
    a CPU tensor (bitwise with the reference: test_torch_random.py,
    test_torch_core.py, test_torch_dme.py)."""
    fn = _device_helpers()[name]
    want = fn(device="cpu")
    assert want.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    torch.testing.assert_close(fn(device="cpu"), want, rtol=0, atol=0)


@pytest.mark.parametrize("pkg", ["agg", "dist", "kernels", "core",
                                 "models"])
def test_package_exports_match_reference(pkg):
    """Each port package binds every name its reference ``__init__``
    binds, and has the reference's ``__all__`` where the reference defines
    one; a reference package with no ``__init__`` (``models``) exports its
    modules, and the port's has a module of each name."""
    import importlib

    ref_dir = ROOT / "src" / "repro" / pkg
    if not (ref_dir / "__init__.py").exists():
        mods = sorted(p.stem for p in ref_dir.glob("*.py"))
        assert mods, pkg
        for m in mods:
            importlib.import_module(f"repro_torch.{pkg}.{m}")
        return
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    tree = ast.parse((ref_dir / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    assert names, pkg
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing
    if hasattr(ref, "__all__"):
        assert port.__all__ == ref.__all__
        assert all(hasattr(port, n) for n in port.__all__)
    else:
        assert not hasattr(port, "__all__")


def test_published_anchor_is_a_tensor_on_the_server_device():
    d = 256
    anchor = np.random.RandomState(1).randn(d).astype(np.float32)
    svc = AggService(ServiceConfig(d=d, bucket=64, y0=1.0), anchor0=anchor,
                     device="cpu")
    spec, a = svc.begin_round()
    server = svc.make_server()
    xs = anchor[None] + 0.1 * np.random.RandomState(2).randn(
        3, d).astype(np.float32)
    for f in TS.fleet_payloads(spec, xs, anchor=a, device="cpu"):
        server.receive(f)
    server.tick()
    server.seal()
    pr = server.published()[0]
    assert isinstance(pr.anchor, torch.Tensor)
    assert pr.anchor.device == server.device and pr.anchor.dtype == \
        torch.float32
    np.testing.assert_array_equal(pr.anchor.numpy(), anchor)
    anchor[:] = 0.0                     # the caller's array is not aliased
    assert pr.anchor.abs().max() > 0
