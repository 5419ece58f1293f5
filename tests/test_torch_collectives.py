"""The port's quantized collectives vs the JAX package's, at world 4 (CPU).

The same numpy-seeded inputs go to both sides, each in its own processes:

* one JAX subprocess with four emulated CPU devices runs every case of
  :data:`CASES` under ``jax.shard_map`` (the reference's Pallas kernels in
  interpret mode) and writes the per-rank outputs and telemetry;
* four port ranks, one process each over a ``gloo`` group, run the same
  cases through ``repro_torch.dist.collectives`` on the plain torch path,
  plus world-1 runs on singleton groups, recording the bytes each rank
  sends.

Both start together; each has its own time limit, so a hang fails the test
instead of eating the suite's.  Unrotated cases are held bitwise in
outputs and per-bucket telemetry.  Rotated cases keep their telemetry
bitwise (it comes from integer coordinates); their means differ by
rounding: unpacked, because the reference's compiled program fuses the
lattice scale into the first stage of the final inverse FWHT (a
contraction the port does not copy), packed, because the reference
rotates with its Pallas FWHT, only allclose to the plain transform.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.agg import rounds as TRd
from repro_torch.agg.client import AggClient
from repro_torch.agg.server import AggServer
from repro_torch.agg.transport import frame as Tw
from repro_torch.dist import collectives as TC
from repro_torch.dist import fsdp as TF

ROOT = Path(__file__).resolve().parents[1]
WORLD, D, BUCKET = 4, 8192, 1024
NB = D // BUCKET
LIMIT_S = 300                      # per subprocess
STAR, BFLY, RH = ("allgather_allreduce_mean", "butterfly_allreduce_mean",
                  "rh_reduce_scatter_mean")
FNS = (STAR, BFLY, RH)
SERVER_SPEC = Tw.RoundSpec(round_id=11, d=D,
                           cfg=TC.QSyncConfig(q=16, bucket=BUCKET), y0=2.0,
                           seed=5)


def _case(fn, packed, state="bare", rotate=False, q=16, d=D, y="y",
          key=(0, 42), tag=""):
    name = (f"{fn.split('_')[0]}-{'packed' if packed else 'unpacked'}-"
            f"{state}{'-rot' if rotate else ''}{tag}")
    return dict(name=name, fn=fn, packed=packed, state=state, rotate=rotate,
                q=q, bucket=BUCKET, d=d, y=y, key=list(key))


CASES = (
    [_case(fn, p, st) for fn in FNS for p in (True, False)
     for st in ("bare", "anchored")]
    + [_case(fn, True, "zero") for fn in FNS]
    + [_case(fn, p, rotate=True, y="y_rot") for fn in FNS
       for p in (True, False)]
    # an odd d: the padding slice and a partial last bucket
    + [_case(fn, True, d=D - 192, tag="-odd") for fn in FNS]
    # q = 2 with a tiny bound: decode failures are detected (the 1.5 y
    # distance surrogate fires only for q = 2)
    + [_case(fn, True, q=2, y="y_tiny", tag="-fails") for fn in FNS]
    # q not a power of two (2- and 4-bit colors the centered mod folds by
    # a remainder): the star and the butterfly
    + [_case(fn, True, q=q, tag=f"-q{q}") for fn in (STAR, BFLY)
       for q in (3, 12)]
    # the server-parity star: the round's key and uniform y0
    + [_case(STAR, True, y="y_server",
             key=TRd.round_key(SERVER_SPEC), tag="-server")])
CASE = {c["name"]: c for c in CASES}


def _inputs():
    rng = np.random.RandomState(12)
    base = (3.0 * rng.randn(D)).astype(np.float32)
    xs = (base[None] + 0.05 * rng.randn(WORLD, D)).astype(np.float32)
    anchor = (base + 0.01 * rng.randn(D)).astype(np.float32)
    dev = np.abs(xs - xs.mean(0)).reshape(WORLD, NB, BUCKET).max(axis=(0, 2))
    y = (2.0 * dev * (1.0 + 0.5 * rng.rand(NB))).astype(np.float32)
    return dict(xs=xs, anchor=anchor, zero=np.zeros(D, np.float32), y=y,
                y_rot=np.full(NB, 2.0, np.float32),
                y_tiny=np.full(NB, 1e-2, np.float32),
                y_server=np.full(NB, SERVER_SPEC.y0, np.float32))


_JAX_SCRIPT = """
import json, sys
from functools import partial
import numpy as np
import repro  # noqa: F401  (jax compatibility shims)
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.qstate import QState
from repro.dist import collectives as C

inp, cases_path, out = sys.argv[1:4]
data = dict(np.load(inp))
mesh = jax.make_mesh((4,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
res = {}
for c in json.load(open(cases_path)):
    fn = getattr(C, c["fn"])
    cfg = C.QSyncConfig(q=c["q"], bucket=c["bucket"], rotate=c["rotate"],
                        packed=c["packed"])
    y = jnp.asarray(data[c["y"]])
    state = y if c["state"] == "bare" else QState(
        y=y, anchor=jnp.asarray(data["anchor" if c["state"] == "anchored"
                                     else "zero"][:c["d"]]))
    key = jnp.asarray(c["key"], jnp.uint32)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("data"),),
             out_specs=P("data"), check_vma=False)
    def f(xl):
        o, aux = fn(xl.reshape(-1), state, key, "data", cfg)
        r = dict(out=o, fails=aux.fails, max_dist=aux.max_dist,
                 y_next=aux.y_next, fails_b=aux.fails_b, dist_b=aux.dist_b)
        if aux.y_seg is not None:
            r["y_seg"] = aux.y_seg
        return {k: v[None] for k, v in r.items()}

    for k, v in jax.jit(f)(jnp.asarray(data["xs"][:, :c["d"]])).items():
        res[c["name"] + "/" + k] = np.asarray(v)
np.savez(out, **res)
"""

_RANK_SCRIPT = """
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.dist import collectives as C

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
inp, cases_path, out = sys.argv[4:7]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
data = dict(np.load(inp))
sent = []

def counted(fn):
    def call(t, *args, **kwargs):
        sent.append(t.numel() * t.element_size())
        return fn(t, *args, **kwargs)
    return call

C._all_gather, C._ppermute = counted(C._all_gather), counted(C._ppermute)

def run(c, x, group=None):
    cfg = C.QSyncConfig(q=c["q"], bucket=c["bucket"], rotate=c["rotate"],
                        packed=c["packed"])
    y = convert.tensor(data[c["y"]], device="cpu")
    state = y if c["state"] == "bare" else convert.qstate_from_numpy(
        data[c["y"]], data["anchor" if c["state"] == "anchored"
                           else "zero"][:c["d"]], device="cpu")
    sent.clear()
    o, aux = getattr(C, c["fn"])(x, state, tuple(c["key"]), cfg, group)
    r = dict(out=o, fails=aux.fails, max_dist=aux.max_dist,
             y_next=aux.y_next, fails_b=aux.fails_b, dist_b=aux.dist_b,
             sent=torch.tensor(sum(sent)))
    if aux.y_seg is not None:
        r["y_seg"] = aux.y_seg
    return r

res = {}
for c in json.load(open(cases_path)):
    x = convert.tensor(data["xs"][rank, :c["d"]], device="cpu")
    for k, v in run(c, x).items():
        res[c["name"] + "/" + k] = v.numpy()
# world 1: every rank alone in its own group
groups = [dist.new_group([r]) for r in range(world)]
for fn in ("allgather_allreduce_mean", "butterfly_allreduce_mean",
           "rh_reduce_scatter_mean"):
    for packed in (True, False):
        c = dict(fn=fn, packed=packed, state="bare", rotate=False, q=16,
                 bucket=256, d=512, y="y1", key=[0, 7])
        data["y1"] = np.ones(2, np.float32)
        x = convert.tensor(data["xs"][rank, :512], device="cpu")
        for k, v in run(c, x, groups[rank]).items():
            res[f"w1-{fn}-{packed}/{k}"] = v.numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _finish(procs, deadline):
    """Wait for every process until ``deadline``; kill all on a failure or
    a hang, and raise with the failed process's output."""
    try:
        for name, p, log in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{name} did not finish in {LIMIT_S} s")
            if p.returncode != 0:
                raise AssertionError(f"{name} exited {p.returncode}:\n"
                                     f"{log.read_text()[-20000:]}")
    finally:
        for _, p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    data = _inputs()
    inp, cases = tmp / "inputs.npz", tmp / "cases.json"
    np.savez(inp, **data)
    cases.write_text(json.dumps(CASES))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")

    def start(name, script, *args):
        log = tmp / f"{name.replace(' ', '_')}.log"
        with open(log, "w") as f:
            p = subprocess.Popen([sys.executable, "-c", script, *map(str, args)],
                                 env=env, stdout=f, stderr=subprocess.STDOUT)
        return name, p, log

    port = _free_port()
    procs = [start("jax reference", _JAX_SCRIPT, inp, cases, tmp / "jax.npz")]
    procs += [start(f"port rank {r}", _RANK_SCRIPT, r, WORLD, port, inp,
                    cases, tmp / f"rank{r}.npz") for r in range(WORLD)]
    _finish(procs, time.monotonic() + LIMIT_S)
    jax_res = dict(np.load(tmp / "jax.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return data, jax_res, ranks


def _port(ranks, name, field):
    return np.stack([r[f"{name}/{field}"] for r in ranks])


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


TELEMETRY = ("fails", "max_dist", "y_next", "fails_b", "dist_b")
FIELDS = ("out",) + TELEMETRY


def _fields(name, fields=FIELDS):
    return fields + (("y_seg",) if CASE[name]["fn"] == RH else ())


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if not c["rotate"]])
def test_port_equals_reference_bitwise(runs, name):
    _, jres, ranks = runs
    for f in _fields(name):
        np.testing.assert_array_equal(_bits(_port(ranks, name, f)),
                                      _bits(jres[f"{name}/{f}"]),
                                      err_msg=f"{name}: {f}")


@pytest.mark.parametrize("fn", FNS)
def test_rotated_unpacked_telemetry_bitwise_mean_to_rounding(runs, fn):
    """Both sides rotate with the plain FWHT in the same stage order, so
    coordinates and telemetry agree bitwise.  The mean differs by
    rounding only: the reference's compiler contracts the last scale
    ``(k + u) * s`` into the first add/subtract stage of the inverse FWHT,
    and a one-ulp change there reaches every output of the bucket at about
    the size of an ulp of its largest coordinate."""
    _, jres, ranks = runs
    name = _case(fn, False, rotate=True)["name"]
    for f in _fields(name, TELEMETRY):
        np.testing.assert_array_equal(_bits(_port(ranks, name, f)),
                                      _bits(jres[f"{name}/{f}"]),
                                      err_msg=f"{name}: {f}")
    got, want = _port(ranks, name, "out"), jres[f"{name}/out"]
    tol = 4 * np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("fn", FNS)
def test_rotated_packed_within_lattice_bound(runs, fn):
    """The reference rotates the packed path with its Pallas FWHT (only
    allclose to the plain transform), so the means agree within the
    lattice bound, not bitwise."""
    data, jres, ranks = runs
    name = _case(fn, True, rotate=True)["name"]
    got, want = _port(ranks, name, "out"), jres[f"{name}/out"]
    assert got.shape == want.shape
    s = 2 * 2.0 / 15
    exact = data["xs"].astype(np.float64).mean(0)
    bound = 0.51 * s * np.sqrt(D) * (1 if fn == STAR else 2)
    if fn == RH:      # segment r of the mean on rank r
        got, want = got.reshape(-1), want.reshape(-1)
        assert np.linalg.norm(got - exact) <= bound
    else:
        for r in range(WORLD):
            assert np.linalg.norm(got[r] - exact) <= bound
        assert np.array_equal(got, np.broadcast_to(got[0], got.shape))
    assert np.linalg.norm(got - want) <= 2 * bound
    np.testing.assert_array_equal(_port(ranks, name, "fails_b"),
                                  jres[f"{name}/fails_b"])


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("variant", [("bare", False), ("anchored", False),
                                     ("bare", True)])
def test_port_packed_equals_unpacked(runs, fn, variant):
    """Mirrors tests/test_dist_collectives.py::test_packed_vs_unpacked_parity_8dev
    on the port alone: both wire paths give the same bits."""
    _, _, ranks = runs
    state, rotate = variant
    y = "y_rot" if rotate else "y"
    p = _case(fn, True, state, rotate=rotate, y=y)["name"]
    u = _case(fn, False, state, rotate=rotate, y=y)["name"]
    for f in _fields(p):
        np.testing.assert_array_equal(_bits(_port(ranks, p, f)),
                                      _bits(_port(ranks, u, f)),
                                      err_msg=f"{fn} {variant}: {f}")


@pytest.mark.parametrize("fn", FNS)
def test_zero_anchor_equals_bare_and_outputs_are_common(runs, fn):
    _, _, ranks = runs
    bare, zero = _case(fn, True)["name"], _case(fn, True, "zero")["name"]
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(_port(ranks, zero, f)),
                                      _bits(_port(ranks, bare, f)))
    for name in (bare, _case(fn, True, "anchored")["name"]):
        assert float(_port(ranks, name, "fails").max()) == 0.0
        if fn != RH:        # the star and butterfly agree on every rank
            o = _port(ranks, name, "out")
            assert np.array_equal(_bits(o), _bits(np.broadcast_to(o[0],
                                                                  o.shape)))


def test_decode_failures_are_detected(runs):
    _, _, ranks = runs
    for fn in FNS:
        name = _case(fn, True, q=2, y="y_tiny", tag="-fails")["name"]
        assert float(_port(ranks, name, "fails").min()) > 0, name
        assert float(_port(ranks, name, "fails_b").max()) > 0, name


def test_server_mean_equals_star_mean_bitwise(runs):
    """Mirrors tests/test_agg.py::test_server_mean_bit_identical_to_star_8dev
    (unrotated) on the port: the aggregation server's mean over the four
    ranks' vectors equals the star collective's, whatever the arrival
    order."""
    data, jres, ranks = runs
    name = _case(STAR, True, y="y_server", key=TRd.round_key(SERVER_SPEC),
                 tag="-server")["name"]
    star = _port(ranks, name, "out")
    np.testing.assert_array_equal(_bits(star[0]), _bits(jres[f"{name}/out"][0]))
    xs = data["xs"]
    server = AggServer(SERVER_SPEC, xs[3], device="cpu")
    for i in np.random.RandomState(1).permutation(WORLD):
        server.receive(AggClient(SERVER_SPEC, int(i), xs[i],
                                 device="cpu").payload())
    mean, stats = server.finalize()
    assert stats.accepted == WORLD
    np.testing.assert_array_equal(_bits(mean.numpy()), _bits(star[0]))


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("packed", [True, False])
def test_world1_is_near_identity(runs, fn, packed):
    """Mirrors tests/test_dist_collectives.py::test_world1_collectives_are_near_identity
    and its packed == unpacked check, on singleton groups."""
    data, _, ranks = runs
    s = 2 * 1.0 / 15
    for r, res in enumerate(ranks):
        out = res[f"w1-{fn}-{packed}/out"]
        assert out.shape == (512,)
        assert np.abs(out - data["xs"][r, :512]).max() <= 0.5 * s + 1e-6
        assert float(res[f"w1-{fn}-{packed}/fails"]) == 0.0
        assert int(res[f"w1-{fn}-{packed}/sent"]) == (
            TC._payload_bytes(512, TC.QSyncConfig(q=16, bucket=256,
                                                  packed=packed))
            if fn == STAR else 0)
        np.testing.assert_array_equal(out, res[f"w1-{fn}-True/out"])


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_bytes_sent_match_wire_accounting(runs, name):
    """Every rank sends exactly what the wire accounting says: one payload
    for the star, one per round for the butterfly, the halving series for
    recursive halving."""
    _, _, ranks = runs
    c = CASE[name]
    cfg = TC.QSyncConfig(q=c["q"], bucket=c["bucket"], packed=c["packed"])
    want = {STAR: TC._payload_bytes(c["d"], cfg),
            BFLY: TC.wire_bytes_butterfly(c["d"], WORLD, cfg),
            RH: TC.wire_bytes_rh(c["d"], WORLD, cfg)}[c["fn"]]
    assert [int(r[f"{name}/sent"]) for r in ranks] == [want] * WORLD


@pytest.mark.parametrize("n,bucket,q,packed", [(8192, 1024, 16, True),
                                               (1000, 128, 16, False),
                                               (12, 4, 256, True),
                                               (1 << 15, 512, 16, True)])
@pytest.mark.parametrize("world", [1, 4, 8])
def test_wire_byte_functions_equal_reference(n, bucket, q, packed, world):
    from repro.dist import collectives as JC
    from repro.dist import fsdp as JF

    jc = JC.QSyncConfig(q=q, bucket=bucket, packed=packed)
    tc = TC.QSyncConfig(q=q, bucket=bucket, packed=packed)
    assert TC._payload_bytes(n, tc) == JC._payload_bytes(n, jc)
    for f in ("wire_bytes_butterfly", "wire_bytes_allgather",
              "wire_bytes_rh"):
        assert getattr(TC, f)(n, world, tc) == getattr(JC, f)(n, world, jc)
    assert TC.wire_bytes_anchor_gather(n, world) == \
        JC.wire_bytes_anchor_gather(n, world)
    assert TF.pad_to_shardable(n, world, bucket) == \
        JF.pad_to_shardable(n, world, bucket)


def test_collectives_reject_what_the_reference_rejects():
    with pytest.raises(ValueError, match="power-of-two"):
        TC._log2_world(6, "butterfly")
    assert TC._log2_world(8, "butterfly") == 3
    with pytest.raises(ValueError, match="entries for"):
        TC._check_buckets(torch.zeros(4, 256), torch.ones(3))
    with pytest.raises(ValueError, match="power of two"):
        TC.QSyncConfig(bucket=48)
