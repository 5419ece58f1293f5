"""The sum-without-decode tree: repro_torch.agg.tree vs repro.agg.tree on
the CPU.

The same numpy-seeded fleet's frames (byte-identical from both packages'
fleet encoders) go through the port's tree, the reference's tree and the
port's flat server: accepted sets and published means are held bitwise,
tiers make no decode dispatch and the root makes one per color space.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.agg import sim as JS
from repro.agg.client import AggClient as JClient
from repro.agg.transport import frame as Jw
from repro.agg.tree import AggTree as JTree
from repro.agg.tree import TierAggregator as JTier
from repro.dist.collectives import QSyncConfig as JQ
from repro_torch import convert
from repro_torch.agg import sim as TS
from repro_torch.agg.api import AggNode
from repro_torch.agg.client import AggClient as TClient
from repro_torch.agg.engine import AggEngine, EngineConfig
from repro_torch.agg.server import AggServer as TServer
from repro_torch.agg.service import AggService, ServiceConfig
from repro_torch.agg.transport import frame as Tw
from repro_torch.agg.tree import TIER_ID_BASE, AggTree, TierAggregator
from repro_torch.kernels import ops as TK


def _specs(d=1024, bucket=128, q=16, mtu=0, y0=0.5, seed=3, round_id=1,
           max_attempts=4, **kw):
    js = Jw.RoundSpec(round_id=round_id, d=d, cfg=JQ(q=q, bucket=bucket),
                      y0=y0, seed=seed, max_attempts=max_attempts, mtu=mtu,
                      **kw)
    return js, convert.round_spec(dataclasses.asdict(js))


def _fleet(js, ts, n, seed=0, spread=0.02, scale=2.0):
    rng = np.random.RandomState(seed)
    base = scale * rng.randn(js.d).astype(np.float32)
    xs = base[None] + spread * rng.randn(n, js.d).astype(np.float32)
    frames = TS.fleet_frames(ts, xs, device="cpu")
    assert frames == JS.fleet_frames(js, xs)
    return base, xs, frames


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.asarray(a, np.float32).view(np.uint32)


def _run(node, frames, max_ticks=16):
    for fs in frames:
        for f in fs:
            node.ingest_frame(f)
    node.tick()
    node.seal()
    for _ in range(max_ticks):
        node.tick()
        prs = node.published()
        if prs:
            return prs[0]
    raise AssertionError("never published within the tick budget")


def _same(a, b):
    assert a.accepted == b.accepted
    np.testing.assert_array_equal(_bits(a.mean), _bits(b.mean))


@pytest.mark.parametrize("fanout,tiers,mtu", [(4, 1, 0), (4, 2, 0),
                                              (4, 2, 160), (8, 1, 256)])
def test_tree_matches_reference_and_flat(fanout, tiers, mtu):
    """The port tree publishes the reference tree's accepted set and mean
    bit for bit, and so does the port's flat server over the same frames;
    every tier forwarded at the same q as the reference's tier."""
    js, ts = _specs(mtu=mtu)
    base, _, frames = _fleet(js, ts, 24)
    jtree = JTree(js, base, fanout=fanout, tiers=tiers)
    ttree = AggTree(ts, base, fanout=fanout, tiers=tiers, device="cpu")
    pj, pt = _run(jtree, frames), _run(ttree, frames)
    _same(pt, pj)
    assert pt.accepted == frozenset(range(24))
    flat = TServer(ts, base, device="cpu")
    _same(pt, _run(flat, frames))
    assert [t.forwarded_q for layer in ttree.layers for t in layer] == \
        [t.forwarded_q for layer in jtree.layers for t in layer]
    for tst, jst in zip(ttree.tier_stats(), jtree.tier_stats()):
        assert dataclasses.asdict(tst) == dataclasses.asdict(jst)


def test_tree_with_escalating_clients_matches_reference():
    """An out-of-bound client escalates against its edge tier with the
    flat server's q <- q^2 handshake; the recovered round equals the
    reference tree's and the port's flat server's bit for bit."""
    js, ts = _specs()
    rng = np.random.RandomState(4)
    base = 2.0 * rng.randn(js.d).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(10, js.d).astype(np.float32)
    xs[7] += 6.0 * js.y0 * rng.choice([-1.0, 1.0], js.d).astype(np.float32)

    def drive(node, mk):
        clients = [mk(i) for i in range(len(xs))]
        inflight = [f for c in clients for f in c.frames()]
        for _ in range(2 * js.max_attempts):
            outs = []
            for f in inflight:
                outs.extend(node.ingest_frame(f))
            outs.extend(node.tick())
            inflight = []
            for rb in outs:
                r = Jw.decode_response(rb)
                if r.client_id < len(clients):
                    inflight.extend(clients[r.client_id].handle_response(rb))
            if not inflight:
                break
        node.seal()
        for _ in range(16):
            node.tick()
            if node.published():
                return node.published()[0], clients
        raise AssertionError("did not publish")

    pj, _ = drive(JTree(js, base, fanout=4), lambda i: JClient(js, i, xs[i]))
    pt, cl = drive(AggTree(ts, base, fanout=4, device="cpu"),
                   lambda i: TClient(ts, i, xs[i], device="cpu"))
    pf, _ = drive(TServer(ts, base, device="cpu"),
                  lambda i: TClient(ts, i, xs[i], device="cpu"))
    assert 7 in pt.accepted and cl[7].attempt == 1
    _same(pt, pj)
    _same(pt, pf)


def test_no_tier_decodes_root_decodes_once_per_color_space():
    fanout = 4
    js, ts = _specs()
    base, _, frames = _fleet(js, ts, 24)
    tree = AggTree(ts, base, fanout=fanout, tiers=2, device="cpu")
    for fs in frames:
        for f in fs:
            tree.ingest_frame(f)
    TK.reset_dispatch_counts()
    tree.tick()                               # every tier folds its children
    assert TK.DISPATCH_COUNTS["lattice_decode_batched"] == 0
    tree.seal()
    for _ in range(16):
        tree.tick()
        if tree.published():
            break
    spaces = {t.forwarded_q for t in tree.layers[0]
              if t.forwarded_q is not None}
    assert tree.published()
    assert TK.DISPATCH_COUNTS["lattice_decode_batched"] == len(spaces) >= 1
    assert TK.DISPATCH_COUNTS["lattice_decode"] == 0
    assert tree.root.stats.drains == 1
    assert tree.root_ingress_payloads <= fanout


def test_tier_saturation_matches_reference():
    """At q0 = 2^16 with no escalation headroom a fold that would push R
    past q_max/2 draws a terminal REJECT (counted saturated), as in the
    reference; the tier still forwards its honest n_summed."""
    js, ts = _specs(d=256, bucket=64, q=1 << 16, max_attempts=1)
    rng = np.random.RandomState(0)
    base = np.zeros(js.d, np.float32)
    side = float(np.max(js.sides_np()))
    xs = np.full((6, js.d), 0.3 * side * float(1 << 15), np.float32)
    xs += 0.01 * side * rng.randn(6, js.d).astype(np.float32)
    frames = TS.fleet_frames(ts, xs, device="cpu")
    assert frames == JS.fleet_frames(js, xs)
    outs = {}
    for name, tier in (("j", JTier(js, base, TIER_ID_BASE)),
                       ("t", TierAggregator(ts, base, TIER_ID_BASE,
                                            device="cpu"))):
        o = []
        for fs in frames:
            for f in fs:
                o.extend(tier.ingest_frame(f))
        o.extend(tier.tick())
        tier.seal()
        o.extend(tier.tick())
        outs[name] = (o, tier)
    (jo, jt), (to, tt) = outs["j"], outs["t"]
    assert to == jo
    assert dataclasses.asdict(tt.stats) == dataclasses.asdict(jt.stats)
    assert tt.stats.saturated >= 1
    assert tt.stats.clients_summed + tt.stats.saturated == 6
    fwd = [m for m in to if m[:len(Tw.MAGIC_PAYLOAD)] == Tw.MAGIC_PAYLOAD]
    assert fwd and Tw.decode_frame(fwd[0])[0].n_summed == tt.n_summed


@pytest.mark.parametrize("anchored", [False, True])
def test_streaming_windowed_tree_matches_reference(anchored):
    """Windowed rounds fold each child's validated ranges on arrival at
    the tier; the published mean equals the reference tree's and the
    port's sealed flat drain."""
    d = 1024
    rng = np.random.RandomState(5)
    base = rng.randn(d).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(8, d).astype(np.float32)
    anchor = base if anchored else None
    from repro.agg import rounds as JR
    js, ts = _specs(d=d, mtu=128, window=2,
                    anchor_digest=JR.anchor_digest(anchor) if anchored
                    else 0)

    def drive(node, mk):
        clients = [mk(i) for i in range(len(xs))]
        outbox = [(c, f) for c in clients for f in c.send_frames()]
        for _ in range(200):
            nxt = []
            for c, f in outbox:
                for rb in node.ingest_frame(f):
                    nxt.extend((c, g) for g in c.handle_response(rb))
            for m in node.tick():
                r = Jw.decode_response(m)
                nxt.extend((c, g) for c in clients
                           if c.client_id == r.client_id
                           for g in c.handle_response(m))
            outbox = nxt
            if all(c.acked for c in clients):
                break
        assert all(c.acked for c in clients)
        node.seal()
        for _ in range(16):
            node.tick()
            if node.published():
                return node.published()[0]
        raise AssertionError("did not publish")

    ttree = AggTree(ts, base, fanout=4, device="cpu")
    assert all(t._streaming for t in ttree.layers[0])
    pt = drive(ttree, lambda i: TClient(ts, i, xs[i], anchor=anchor,
                                        device="cpu"))
    pj = drive(JTree(js, base, fanout=4),
               lambda i: JClient(js, i, xs[i], anchor=anchor))
    _same(pt, pj)
    flat = TServer(ts, base, streaming=False, device="cpu")
    for i in range(len(xs)):
        for f in TClient(ts, i, xs[i], anchor=anchor, device="cpu").frames():
            flat.receive(f)
    mean, _ = flat.finalize()
    np.testing.assert_array_equal(_bits(pt.mean), _bits(mean))
    if anchored:
        assert isinstance(pt.anchor, torch.Tensor)


def test_every_endpoint_satisfies_the_aggnode_protocol():
    _, ts = _specs(d=256, bucket=64)
    base = np.zeros(ts.d, np.float32)
    eng = AggEngine(AggService(ServiceConfig(d=256, bucket=64),
                               device="cpu"), EngineConfig(), now=0.0)
    for node in (TServer(ts, base, device="cpu"), eng,
                 TierAggregator(ts, base, TIER_ID_BASE, device="cpu"),
                 AggTree(ts, base, fanout=2, device="cpu")):
        assert isinstance(node, AggNode), type(node)
        assert isinstance(node.published(), list)
    with pytest.raises(ValueError, match="fanout"):
        AggTree(ts, base, fanout=1, device="cpu")
    with pytest.raises(ValueError, match="tiers"):
        AggTree(ts, base, tiers=0, device="cpu")


def test_tree_state_lives_on_its_device():
    _, ts = _specs(d=256, bucket=64)
    base = np.ones(ts.d, np.float32)
    tier = TierAggregator(ts, base, TIER_ID_BASE, device="cpu")
    assert tier._R.dtype == torch.int64 and tier._R.device.type == "cpu"
    assert tier._k0.dtype == torch.int32 and tier._k0.shape == (ts.padded,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TierAggregator(ts, base, TIER_ID_BASE)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AggTree(ts, base, fanout=2)
