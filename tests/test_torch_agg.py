"""One aggregation round: repro_torch.agg vs repro.agg on the CPU.

The same numpy-seeded spec, anchor and client vectors go to both packages
(the port's spec through ``repro_torch.convert``).  Frames, checksums and
published means of unrotated rounds are held bitwise, and so is the
drain's distance telemetry (the port rounds the mul-sub once, as the
reference's compiler fuses it); rotated rounds, whose FWHT sums in another
order, within the lattice bound.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.agg import rounds as JR
from repro.agg.client import AggClient as JClient
from repro.agg.server import AggServer as JServer
from repro.agg.transport import frame as Jw
from repro.dist.collectives import QSyncConfig as JQ
from repro_torch import convert
from repro_torch.agg.client import AggClient as TClient
from repro_torch.agg.server import AggServer as TServer
from repro_torch.agg.transport import frame as Tw
from repro_torch.kernels import ops as TK

ROOT = Path(__file__).resolve().parents[1]


def _specs(d=1000, bucket=128, rotate=False, y0=0.5, seed=21, round_id=4,
           anchor=None, **kw):
    js = Jw.RoundSpec(round_id=round_id, d=d,
                      cfg=JQ(q=16, bucket=bucket, rotate=rotate), y0=y0,
                      seed=seed,
                      anchor_digest=JR.anchor_digest(anchor)
                      if anchor is not None else 0, **kw)
    return js, convert.round_spec(dataclasses.asdict(js))


def _fleet(d, S, seed=0, spread=0.02):
    rng = np.random.RandomState(seed)
    base = rng.randn(d).astype(np.float32)
    xs = base[None] + spread * rng.randn(S, d).astype(np.float32)
    return base, xs


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _tmean(server):
    mean, stats = server.finalize()
    assert isinstance(mean, torch.Tensor) and mean.device.type == "cpu"
    return mean.numpy(), stats


@pytest.mark.parametrize("anchored", [False, True])
def test_client_frames_byte_identical(anchored):
    base, xs = _fleet(1000, 3)
    anchor = base if anchored else None
    js, ts = _specs(d=1000, bucket=128, anchor=anchor)
    for i, x in enumerate(xs):
        jc = JClient(js, i, x, anchor=anchor)
        tc = TClient(ts, i, x, anchor=anchor, device="cpu")
        assert tc.payload() == jc.payload()
        assert tc.frames(1) == jc.frames(1)          # escalated re-pack


@pytest.mark.parametrize("anchored", [False, True])
def test_cross_frames_publish_bitwise_equal_means(anchored):
    d, S = 1000, 6
    base, xs = _fleet(d, S, seed=2)
    anchor = base if anchored else None
    js, ts = _specs(d=d, anchor=anchor)
    jframes = [JClient(js, i, xs[i], anchor=anchor).payload()
               for i in range(S)]
    tframes = [TClient(ts, i, xs[i], anchor=anchor, device="cpu").payload()
               for i in range(S)]
    assert tframes == jframes
    ref = JServer(js, base)
    for f in jframes:
        ref.receive(f)
    jmean, jstats = ref.finalize()
    # reference frames into the port server
    ts_srv = TServer(ts, base, device="cpu")
    for f in jframes:
        ts_srv.receive(f)
    tmean, tstats = _tmean(ts_srv)
    np.testing.assert_array_equal(_bits(tmean), _bits(jmean))
    assert tstats.accepted == jstats.accepted == S
    np.testing.assert_array_equal(tstats.dist_b, jstats.dist_b)
    np.testing.assert_array_equal(tstats.max_dist, jstats.max_dist)
    np.testing.assert_array_equal(tstats.fails_b, jstats.fails_b)
    # port frames into the reference server
    js_srv = JServer(js, base)
    for f in tframes:
        js_srv.receive(f)
    np.testing.assert_array_equal(_bits(js_srv.finalize()[0]), _bits(jmean))


def test_single_batched_dispatch_per_drain():
    d, S = 1000, 7
    base, xs = _fleet(d, S, seed=5)
    _, ts = _specs(d=d, bucket=128)
    server = TServer(ts, base, device="cpu")
    for i in range(S):
        server.receive(TClient(ts, i, xs[i], device="cpu").payload())
    TK.reset_dispatch_counts()
    server.drain()
    assert TK.DISPATCH_COUNTS["lattice_decode_batched"] == 1
    assert TK.DISPATCH_COUNTS["lattice_decode"] == 0
    assert sorted(server.accepted_clients) == list(range(S))


def test_chunked_drain_epilogue_matches_one_chunk(monkeypatch):
    """The drain's epilogue over many column chunks publishes the same
    bits and telemetry as over one chunk (at full width it always runs in
    chunks)."""
    from repro_torch.agg import server as server_mod

    d, S = 1000, 5
    base, xs = _fleet(d, S, seed=6)
    xs[4, ::7] += 2.0                       # one sender fails its checksum
    _, ts = _specs(d=d, bucket=128, y0=0.5)
    frames = [TClient(ts, i, xs[i], device="cpu").payload() for i in range(S)]

    def run():
        srv = TServer(ts, base, device="cpu")
        for f in frames:
            srv.receive(f)
        return _tmean(srv)

    mean1, st1 = run()
    monkeypatch.setattr(server_mod, "_EPILOGUE_ELEMS", 2 * 128 * S)
    assert server_mod._epilogue_cols(S, 128) == 256
    mean2, st2 = run()
    np.testing.assert_array_equal(_bits(mean2), _bits(mean1))
    np.testing.assert_array_equal(st2.dist_b, st1.dist_b)
    np.testing.assert_array_equal(st2.fails_b, st1.fails_b)
    assert (st2.accepted, st2.decode_failures) == \
        (st1.accepted, st1.decode_failures) == (S - 1, 1)


def _run_escalation(client_cls, server, spec, base, **kw):
    clients = {
        0: client_cls(spec, 0, base + 0.01, **kw),
        1: client_cls(spec, 1, base + 3.0, **kw),   # needs q=256
        2: client_cls(spec, 2, base + 1e6, **kw),   # beyond the q cap
    }
    for c in clients.values():
        server.receive(c.payload())
    resps = server.drain()
    while resps:
        retries = [p for rb in resps
                   for p in clients[Jw.decode_response(rb).client_id]
                   .handle_response(rb)]
        if not retries:
            break
        for p in retries:
            server.receive(p)
        resps = server.drain()
    return clients


def test_nack_escalation_round_matches_reference():
    d = 1000
    base = np.random.RandomState(0).randn(d).astype(np.float32)
    js, ts = _specs(d=d, bucket=128, y0=0.5, max_attempts=4)
    jsrv = JServer(js, base)
    jcl = _run_escalation(JClient, jsrv, js, base)
    jmean, jstats = jsrv.finalize()
    tsrv = TServer(ts, base, device="cpu")
    tcl = _run_escalation(TClient, tsrv, ts, base, device="cpu")
    tmean, tstats = _tmean(tsrv)
    assert sorted(tsrv.accepted_clients) == [0, 1]
    assert tcl[1].attempt == 1 and not tcl[1].gave_up
    assert tcl[2].gave_up and tstats.gave_up == 1
    assert tstats.nacks_sent == jstats.nacks_sent >= 1
    assert tstats.decode_failures == jstats.decode_failures
    assert [c.attempt for c in tcl.values()] == \
        [c.attempt for c in jcl.values()]
    np.testing.assert_array_equal(_bits(tmean), _bits(jmean))
    np.testing.assert_array_equal(tstats.fails_b, jstats.fails_b)


def _drive_windowed(server, clients):
    outbox = [(c, f) for c in clients for f in c.send_frames()]
    for _ in range(200):
        nxt = []
        for c, f in outbox:
            for rb in server.ingest_frame(f):
                nxt.extend((c, g) for g in c.handle_response(rb))
        for m in server.tick():
            r = Tw.decode_response(m)
            for c in clients:
                if c.client_id == r.client_id:
                    nxt.extend((c, g) for g in c.handle_response(m))
        outbox = nxt
        if all(c.acked for c in clients):
            break
    assert all(c.acked for c in clients)


@pytest.mark.parametrize("anchored", [False, True])
def test_streaming_windowed_round_bit_identical_to_sealed(anchored):
    d, S = 1000, 5
    base, xs = _fleet(d, S, seed=8)
    anchor = base if anchored else None
    js, ts = _specs(d=d, anchor=anchor, mtu=200, window=2)
    sealed = TServer(ts, base, streaming=False, device="cpu")
    for i in range(S):
        for f in TClient(ts, i, xs[i], anchor=anchor, device="cpu").frames():
            sealed.receive(f)
    smean, sstats = _tmean(sealed)
    stream = TServer(ts, base, device="cpu")
    assert stream._streaming
    clients = [TClient(ts, i, xs[i], anchor=anchor, device="cpu")
               for i in range(S)]
    assert len(clients[0].frames()) >= 3
    _drive_windowed(stream, clients)
    stream.seal()
    pub = stream.published()[0]
    assert pub.accepted == frozenset(range(S))
    np.testing.assert_array_equal(_bits(pub.mean.numpy()), _bits(smean))
    np.testing.assert_array_equal(pub.stats.dist_b, sstats.dist_b)
    # and the reference's streaming server publishes the same bits
    jstream = JServer(js, base)
    for i in range(S):
        for f in JClient(js, i, xs[i], anchor=anchor).frames():
            jstream.receive(f)
    np.testing.assert_array_equal(_bits(jstream.finalize()[0]), _bits(smean))


def test_rotated_round_within_lattice_bound():
    d, S = 1000, 5
    base, xs = _fleet(d, S, seed=3)
    js, ts = _specs(d=d, rotate=True, y0=0.5)
    jsrv = JServer(js, base)
    tsrv = TServer(ts, base, device="cpu")
    for i in range(S):
        jsrv.receive(JClient(js, i, xs[i]).payload())
        tsrv.receive(TClient(ts, i, xs[i], device="cpu").payload())
    jmean, _ = jsrv.finalize()
    tmean, tstats = _tmean(tsrv)
    assert tstats.accepted == S
    s = 2 * js.y0 / (js.cfg.q - 1)
    # both are within the lattice error of the exact mean, hence of each
    # other (the rotation is orthonormal: bound the l2 error)
    exact = xs.astype(np.float64).mean(0)
    bound = 0.51 * s * np.sqrt(ts.padded)
    assert np.linalg.norm(tmean - exact) <= bound
    assert np.linalg.norm(tmean - jmean) <= 2 * bound


def test_entry_points_need_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, ts = _specs(d=600, bucket=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TClient(ts, 0, np.zeros(600, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TServer(ts, np.zeros(600, np.float32))


def test_convert_tensor_runs_on_the_card_unless_asked(monkeypatch):
    """``convert.tensor`` goes through ``resolve_device``: with no card and
    no device named it raises; asked for the CPU it gives an equal CPU
    tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(12, dtype=np.float64).reshape(3, 4) / 7
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tensor(x)
    t = convert.tensor(x, device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), x.astype(np.float32))


def test_port_imports_no_jax_and_no_reference():
    code = ("import sys, repro_torch.agg.server, repro_torch.agg.client, "
            "repro_torch.agg.service, repro_torch.agg.engine, "
            "repro_torch.agg.tree, repro_torch.agg.sim, repro_torch.agg, "
            "repro_torch.dist, repro_torch.convert, repro_torch.kernels.ops, "
            "repro_torch.dist.fsdp, repro_torch.models.config, "
            "repro_torch.models.sharding, repro_torch.models.layers, "
            "repro_torch.models.transformer, repro_torch.train.optim, "
            "repro_torch.train.data, repro_torch.train.checkpoint, "
            "repro_torch.train.trainer, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.launch.steps, "
            "repro_torch.launch.trace_analysis, repro_torch.launch.dryrun, "
            "repro_torch.launch.reanalyze, repro_torch.configs.registry; "
            "from repro_torch.configs import registry; "
            "[registry.config(a) for a in registry.ARCHS]; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for bad in ("import jax", "from jax", "from repro.",
                    "import repro.", "from repro import"):
            assert bad not in text, (path, bad)
