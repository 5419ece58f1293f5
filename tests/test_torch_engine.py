"""The continuous-round engine and the open-loop sim: repro_torch.agg vs
repro.agg on the CPU.

Both engines see the same frames at the same virtual times (the open-loop
trace is drawn with numpy's RandomState in both packages), so they cut
over, expire, retry and publish alike; published rounds are compared by
round id, accepted set and the bits of the mean, and every port round is
replayed through a fresh lockstep port server (inside ``run_open_loop``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.agg import sim as JS
from repro.agg.client import AggClient as JClient
from repro.agg.engine import AggEngine as JEngine
from repro.agg.engine import EngineConfig as JEngineConfig
from repro.agg.service import AggService as JService
from repro.agg.service import ServiceConfig as JServiceConfig
from repro_torch.agg import sim as TS
from repro_torch.agg.client import AggClient as TClient
from repro_torch.agg.engine import AggEngine, EngineConfig
from repro_torch.agg.service import AggService, ServiceConfig
from repro_torch.agg.transport import frame as Tw
from repro_torch.kernels import ops as TK

D, BUCKET = 256, 64


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.asarray(a, np.float32).view(np.uint32)


def _assert_same_published(tpubs, jpubs):
    assert [p.round_id for p in tpubs] == [p.round_id for p in jpubs]
    for t, j in zip(tpubs, jpubs):
        assert t.accepted == j.accepted, t.round_id
        np.testing.assert_array_equal(_bits(t.mean), _bits(j.mean))
        assert t.spec.anchor_digest == j.spec.anchor_digest
        assert t.spec.y_buckets == j.spec.y_buckets
        assert (t.opened_at, t.sealed_at, t.published_at, t.anchor_round,
                t.staleness) == (j.opened_at, j.sealed_at, j.published_at,
                                 j.anchor_round, j.staleness)
        if j.anchor is None:
            assert t.anchor is None
        else:
            assert isinstance(t.anchor, torch.Tensor)
            np.testing.assert_array_equal(_bits(t.anchor), _bits(j.anchor))
        for k in ("accepted", "expired", "retried", "resends_sent",
                  "nacks_sent", "gave_up", "decode_failures"):
            assert getattr(t.stats, k) == getattr(j.stats, k), (t.round_id, k)


@pytest.mark.parametrize("window", [0, 2])
def test_open_loop_matches_reference(window):
    """Poisson arrivals, a flash crowd, churn, stragglers and 3% frame loss
    over chunked frames (windowed too): the port engine publishes the
    reference engine's rounds with the same accepted sets, telemetry and
    means bit for bit; ``run_open_loop`` replays each of its rounds through
    a fresh lockstep server, and no benign client gets a terminal
    verdict."""
    jr = JS.run_open_loop(JS.OpenLoopConfig(window=window),
                          check_parity=False)
    tr = TS.run_open_loop(TS.OpenLoopConfig(window=window),
                          check_parity=True, device="cpu")
    _assert_same_published(tr.published, jr.published)
    assert tr.rounds >= 3 and tr.max_live_rounds >= 3
    assert tr.expired_total > 0 and tr.retried_total > 0
    assert tr.resends_total > 0
    if window:
        assert tr.window_stalls > 0
    tj, tt = dataclasses.asdict(jr), dataclasses.asdict(tr)
    tj.pop("published"), tt.pop("published")
    assert tt == tj


def test_replay_published_round_rejects_a_moved_mean():
    cfg = TS.OpenLoopConfig(duration=0.2, flash_at=())
    rep = TS.run_open_loop(cfg, check_parity=False, device="cpu")
    trace = TS._make_trace(cfg)
    pr = rep.published[0]
    assert torch.equal(TS.replay_published_round(trace, pr), pr.mean)
    moved = dataclasses.replace(pr, mean=pr.mean + 1e-3)
    with pytest.raises(AssertionError, match="lockstep replay"):
        TS.replay_published_round(trace, moved)


def test_lockstep_matches_reference():
    cfg = dict(duration=0.3)
    jl = JS.run_lockstep(JS.OpenLoopConfig(**cfg))
    tl = TS.run_lockstep(TS.OpenLoopConfig(**cfg), device="cpu")
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
    assert tl.rounds >= 2


# ---------------------------------------------------------------------------
# Driven engines, port vs reference
# ---------------------------------------------------------------------------

def _pair(engine_kw=None, **svc_kw):
    skw = dict(d=D, bucket=BUCKET, y0=1.0, seed=3, anchored=True)
    skw.update(svc_kw)
    ekw = dict(quorum=2, round_deadline=1.0, straggler_deadline=0.2,
               max_resends=1, drain_deadline=5.0, max_live_rounds=3)
    ekw.update(engine_kw or {})
    j = JEngine(JService(JServiceConfig(**skw)), JEngineConfig(**ekw),
                now=0.0)
    t = AggEngine(AggService(ServiceConfig(**skw), device="cpu"),
                  EngineConfig(**ekw), now=0.0)
    return j, t


def _xs(n, seed=0, scale=0.1):
    return scale * np.random.RandomState(seed).randn(n, D).astype(np.float32)


def _jclient(rnd, cid, x):
    return JClient(rnd.spec, cid, x, anchor=rnd.client_anchor)


def _tclient(rnd, cid, x):
    return TClient(rnd.spec, cid, x, anchor=rnd.client_anchor, device="cpu")


def test_quorum_and_deadline_cutover_match_reference():
    """Quorum met before the deadline seals at once; an empty round
    re-arms at its deadline; a lone client is published at the next
    deadline.  Both engines take the same steps and publish the same
    bits."""
    xs = _xs(3)
    out = []
    for eng, mk in zip(_pair(engine_kw=dict(quorum=2)), (_jclient, _tclient)):
        r1 = eng.open_round
        for cid in (0, 1):
            eng.receive(mk(r1, cid, xs[cid]).payload(), now=0.1)
        assert r1.state.value == "published"
        assert r1.sealed_at == 0.1 and eng.open_round.round_id == 2
        r2 = eng.open_round
        eng.advance(now=1.5)                 # empty at the deadline: re-arm
        assert r2.state.value == "open" and r2.opened_at == 1.5
        eng.receive(mk(r2, 2, xs[2]).payload(), now=1.6)
        assert r2.state.value == "open"
        eng.advance(now=2.6)                 # deadline, 1 >= min_clients
        assert r2.state.value == "published"
        out.append(eng.published)
    jpubs, tpubs = out
    assert [p.accepted for p in tpubs] == [frozenset({0, 1}),
                                           frozenset({2})]
    _assert_same_published(tpubs, jpubs)


def test_straggler_resend_budget_then_expiry_matches_reference():
    """An admitted client that stops mid-payload taps its RESEND budget at
    each straggler deadline, then expires without a verdict; the round
    publishes without it and the client re-enrolls in the next round."""
    xs = _xs(2)
    out = []
    for eng, mk in zip(_pair(engine_kw=dict(quorum=2), mtu=100),
                       (_jclient, _tclient)):
        r1 = eng.open_round
        good, lost = mk(r1, 0, xs[0]), mk(r1, 1, xs[1])
        for f in good.frames():
            eng.receive(f, now=0.1)
        eng.receive(lost.frames()[0], now=0.1)   # quorum -> seal
        assert r1.server.unresolved == frozenset({1})
        resends = [Tw.decode_response(o) for o in eng.advance(now=0.35)]
        resends = [r for r in resends if r.status == Tw.STATUS_RESEND]
        assert [(r.client_id, r.missing) for r in resends] == [(1, (1,))]
        assert r1.state.value == "sealing"
        eng.advance(now=0.6)                     # budget spent: expire
        assert r1.state.value == "published" and not lost.gave_up
        r2 = eng.open_round
        for f in mk(r2, 1, xs[1]).frames():
            eng.receive(f, now=0.7)
        r2.server.drain()
        assert 1 in r2.server.accepted_clients
        out.append(eng.published)
    jpubs, tpubs = out
    assert tpubs[0].stats.expired == 1 and tpubs[0].stats.gave_up == 0
    assert tpubs[0].accepted == frozenset({0})
    _assert_same_published(tpubs, jpubs)


def test_window_overflow_and_flush_match_reference():
    """max_live_rounds bounds the live window: a cutover force-publishes
    the oldest sealing round; flush publishes the rest in order."""
    xs = _xs(4)
    out = []
    for eng, mk in zip(_pair(engine_kw=dict(quorum=1, max_live_rounds=2,
                                            straggler_deadline=99.0,
                                            drain_deadline=99.0), mtu=100),
                       (_jclient, _tclient)):
        for k in range(3):
            rnd = eng.open_round
            eng.receive(mk(rnd, k, xs[k]).frames()[0], now=0.1 * (k + 1))
        assert [p.round_id for p in eng.published] == [1, 2]
        assert eng.live_rounds == 2
        rnd = eng.open_round
        for f in mk(rnd, 3, xs[3]).frames()[:1]:
            eng.receive(f, now=0.5)
        eng.flush(1.0)
        out.append(eng.published)
    jpubs, tpubs = out
    assert all(p.stats.expired == 1 for p in tpubs)
    _assert_same_published(tpubs, jpubs)


def test_engine_drains_with_one_batched_decode_per_round():
    """Every sealed round's drain issues one batched decode and no single
    decode: the engine only routes frames to its servers."""
    _, eng = _pair(engine_kw=dict(quorum=4))
    xs = _xs(4)
    rnd = eng.open_round
    frames = [_tclient(rnd, cid, xs[cid]).payload() for cid in range(4)]
    TK.reset_dispatch_counts()
    for f in frames:
        eng.receive(f, now=0.1)
    assert eng.published and eng.published[0].accepted == frozenset(range(4))
    assert TK.DISPATCH_COUNTS["lattice_decode_batched"] == 1
    assert TK.DISPATCH_COUNTS["lattice_decode"] == 0


def test_engine_rejects_a_window_below_two():
    with pytest.raises(ValueError, match="max_live_rounds"):
        AggEngine(AggService(ServiceConfig(d=D, bucket=BUCKET),
                             device="cpu"), EngineConfig(max_live_rounds=1))
