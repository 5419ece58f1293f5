"""The port's FSDP gather vs the JAX package's, at world 4 (CPU).

The same numpy-seeded weight shards and cotangents go to both sides, each
in its own processes, as in ``tests/test_torch_collectives.py``: one JAX
subprocess with four emulated CPU devices runs every case of :data:`CASES`
under ``jax.shard_map`` (``jax.vjp`` of ``make_fsdp_gather``; the Pallas
kernels in interpret mode), and four port ranks over a ``gloo`` group run
the same cases through ``repro_torch.dist.fsdp`` (``out.backward(ct)``),
monolithic and split.  Each has its own time limit.

Held: the forward bitwise; the backward's shard and its whole telemetry row
bitwise for lq packed and unpacked, decode failures, anchored with a
sharded and with a replicated anchor, and a (2, 2) two-axis DP layout; the
f32 sync (gloo has no reduce-scatter; the port sums the ranks in rank
order) to one ulp; split == monolithic bitwise; the bytes each rank sends
== ``wire_bytes_bwd``; the same leaf-sync order on every rank.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro_torch.dist import collectives as TC
from repro_torch.dist import fsdp as TF

ROOT = Path(__file__).resolve().parents[1]
WORLD, SHARD, BUCKET = 4, 1024, 64
M = WORLD * SHARD
NB = M // BUCKET
LIMIT_S = 300


def _case(name, packed=True, sync="lq", anchored=False, sharded=True,
          axes=("data",), q=16, y="y"):
    return dict(name=name, packed=packed, sync=sync, anchored=anchored,
                sharded=sharded, axes=list(axes), q=q, y=y, bucket=BUCKET)


CASES = [
    _case("lq-packed"),
    _case("lq-unpacked", packed=False),
    _case("lq-fails", q=2, y="y_tiny"),
    _case("anchored-sharded", anchored=True),
    _case("anchored-replicated", anchored=True, sharded=False),
    _case("anchored-unpacked", packed=False, anchored=True),
    _case("two-axis", axes=("pod", "data")),
    _case("two-axis-unpacked", packed=False, axes=("pod", "data")),
    _case("fp32", sync="fp32"),
]
CASE = {c["name"]: c for c in CASES}


def _tele_width(c):
    if not c["anchored"]:
        return TF.tele_width(NB)
    return TF.tele_width(NB, SHARD if c["sharded"] else M, True)


def _inputs():
    rng = np.random.RandomState(21)
    base = rng.randn(M).astype(np.float32)
    cts = (base[None] + 0.05 * rng.randn(WORLD, M)).astype(np.float32)
    return dict(w=rng.randn(WORLD, SHARD).astype(np.float32), ct=cts,
                anchor=(base + 0.01 * rng.randn(M)).astype(np.float32),
                y=(0.4 + 0.2 * rng.rand(NB)).astype(np.float32),
                y_tiny=np.full(NB, 1e-3, np.float32))


_JAX_SCRIPT = """
import json, sys
from functools import partial
import numpy as np
import repro  # noqa: F401  (jax compatibility shims)
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist import fsdp as F
from repro.dist.collectives import QSyncConfig

inp, cases_path, out, widths = sys.argv[1:5]
data = dict(np.load(inp))
widths = json.loads(widths)
Auto = (jax.sharding.AxisType.Auto,)
meshes = {("data",): jax.make_mesh((4,), ("data",), axis_types=Auto),
          ("pod", "data"): jax.make_mesh((2, 2), ("pod", "data"),
                                         axis_types=Auto * 2)}
res = {}
for c in json.load(open(cases_path)):
    axes = tuple(c["axes"])
    spec = P(axes if len(axes) > 1 else axes[0])
    cfg = F.FSDPConfig(axes=axes, qcfg=QSyncConfig(
        q=c["q"], bucket=c["bucket"], packed=c["packed"]), sync=c["sync"],
        anchored=c["anchored"], anchor_sharded=c["sharded"])
    gather = F.make_fsdp_gather(cfg)
    y = jnp.asarray(data[c["y"]])
    width = widths[c["name"]]
    if c["sharded"]:
        anc, anc_spec = data["anchor"].reshape(4, -1), spec
    else:
        anc, anc_spec = data["anchor"], P()

    @partial(jax.shard_map, mesh=meshes[axes], in_specs=(spec, spec, anc_spec),
             out_specs=spec, check_vma=False)
    def f(wl, ctl, al):
        yv = {"y": y, "anchor": al.reshape(-1)} if c["anchored"] else y
        bundle = {"w": wl.reshape(-1), "y": yv,
                  "key": jax.random.PRNGKey(3),
                  "tele": jnp.zeros((width,), jnp.float32)}
        o, vjp = jax.vjp(gather, bundle)
        (ct_b,) = vjp(ctl.reshape(-1).astype(o.dtype))
        return {"out": o.astype(jnp.float32)[None], "g": ct_b["w"][None],
                "tele": ct_b["tele"][None]}

    for k, v in jax.jit(f)(data["w"], data["ct"], anc).items():
        res[c["name"] + "/" + k] = np.asarray(v)
np.savez(out, **res)
"""

_RANK_SCRIPT = """
import datetime, json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert, random as R
from repro_torch.dist import collectives as C
from repro_torch.dist import fsdp as F
from repro_torch.launch.mesh import make_groups

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
inp, cases_path, out, widths = sys.argv[4:8]
widths = json.loads(widths)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
data = dict(np.load(inp))
groups = {("data",): make_groups((4,)), ("pod", "data"): make_groups((2, 2))}
sent = []
ppermute = C._ppermute

def counted(t, *args, **kwargs):
    sent.append(t.numel() * t.element_size())
    return ppermute(t, *args, **kwargs)
C._ppermute = counted

def run(c, split):
    axes = tuple(c["axes"])
    cfg = F.FSDPConfig(axes=groups[axes], qcfg=C.QSyncConfig(
        q=c["q"], bucket=c["bucket"], packed=c["packed"]), sync=c["sync"],
        anchored=c["anchored"], anchor_sharded=c["sharded"])
    w = convert.tensor(data["w"][rank], "cpu").requires_grad_()
    tele = torch.zeros(widths[c["name"]], requires_grad=True)
    y = convert.tensor(data[c["y"]], "cpu")
    if c["anchored"]:
        a = data["anchor"]
        if c["sharded"]:
            a = a.reshape(4, -1)[rank]
        y = {"y": y, "anchor": convert.tensor(a, "cpu")}
    bundle = {"w": w, "y": y, "key": R.PRNGKey(3), "tele": tele}
    if split:
        g_async, g_wait = F.make_fsdp_gather_split(cfg)
        o = g_wait(g_async(bundle))
    else:
        o = F.make_fsdp_gather(cfg)(bundle)
    sent.clear()
    o.backward(convert.tensor(data["ct"][rank], "cpu").to(o.dtype))
    return dict(out=o.detach().float(), g=w.grad, tele=tele.grad,
                sent=torch.tensor(sum(sent)))

res = {}
for c in json.load(open(cases_path)):
    for split in (False, True):
        tag = c["name"] + ("/split" if split else "")
        for k, v in run(c, split).items():
            res[tag + "/" + k] = v.numpy()

# leaf-sync order: three leaves through one loss; every rank records the
# keys its backward syncs, in order
order = []
sync = F._sync_grad
def recorded(cfg, g, y_entry, key, *args):
    order.append(list(key))
    return sync(cfg, g, y_entry, key, *args)
F._sync_grad = recorded
cfg = F.FSDPConfig(qcfg=C.QSyncConfig(q=16, bucket=64))
gather = F.make_fsdp_gather(cfg)
loss = 0.0
for i, n in enumerate((1024, 256, 2048)):
    w = torch.full((n,), 0.1 * (i + 1), requires_grad=True)
    t = torch.zeros(F.tele_width(n * 4 // 64), requires_grad=True)
    full = gather({"w": w, "y": torch.ones(n * 4 // 64),
                   "key": R.fold_in(R.PRNGKey(5), i), "tele": t}).float()
    loss = loss + (full * full.sum() * (i + 1)).sum()
loss.backward()
res["order"] = np.asarray(order, np.int64)
np.savez(out, **res)
dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket
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
    tmp = tmp_path_factory.mktemp("fsdp")
    data = _inputs()
    inp, cases = tmp / "inputs.npz", tmp / "cases.json"
    np.savez(inp, **data)
    cases.write_text(json.dumps(CASES))
    widths = json.dumps({c["name"]: _tele_width(c) for c in CASES})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")

    def start(name, script, *args):
        log = tmp / f"{name.replace(' ', '_')}.log"
        with open(log, "w") as f:
            p = subprocess.Popen([sys.executable, "-c", script,
                                  *map(str, args)], env=env, stdout=f,
                                 stderr=subprocess.STDOUT)
        return name, p, log

    port = _free_port()
    procs = [start("jax reference", _JAX_SCRIPT, inp, cases, tmp / "jax.npz",
                   widths)]
    procs += [start(f"port rank {r}", _RANK_SCRIPT, r, WORLD, port, inp,
                    cases, tmp / f"rank{r}.npz", widths)
              for r in range(WORLD)]
    _finish(procs, time.monotonic() + LIMIT_S)
    jax_res = dict(np.load(tmp / "jax.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return data, jax_res, ranks


def _port(ranks, key):
    return np.stack([r[key] for r in ranks])


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_forward_gather_bitwise(runs, name):
    _, jres, ranks = runs
    got = _port(ranks, f"{name}/out")
    assert got.shape == (WORLD, M)
    np.testing.assert_array_equal(_bits(got), _bits(jres[f"{name}/out"]))


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if c["sync"] == "lq"])
def test_backward_shard_and_telemetry_bitwise(runs, name):
    _, jres, ranks = runs
    for field in ("g", "tele"):
        np.testing.assert_array_equal(
            _bits(_port(ranks, f"{name}/{field}")),
            _bits(jres[f"{name}/{field}"]), err_msg=f"{name} {field}")


def test_fp32_sync_within_one_ulp(runs):
    """The exact mean, summed in another order than XLA's psum_scatter:
    within one f32 ulp of the reference's value; the telemetry is zero."""
    _, jres, ranks = runs
    got = _port(ranks, "fp32/g")
    want = jres["fp32/g"]
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)
    assert not _port(ranks, "fp32/tele").any()
    assert not jres["fp32/tele"].any()


def test_decode_failures_reach_the_telemetry(runs):
    _, jres, ranks = runs
    tele = _port(ranks, "lq-fails/tele")
    assert tele[:, 1].min() > 0                          # fails
    fails_b = tele[:, TF.TELE_WIDTH + NB:TF.TELE_WIDTH + 2 * NB]
    assert fails_b.max() > 0
    # every rank reports the same full-leaf maps
    assert np.array_equal(tele[:, 3:], np.broadcast_to(tele[0, 3:],
                                                       tele[:, 3:].shape))


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_split_equals_monolithic(runs, name):
    _, _, ranks = runs
    for field in ("out", "g", "tele"):
        np.testing.assert_array_equal(
            _bits(_port(ranks, f"{name}/split/{field}")),
            _bits(_port(ranks, f"{name}/{field}")), err_msg=field)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_bytes_sent_match_wire_bytes_bwd(runs, name):
    _, _, ranks = runs
    c = CASE[name]
    cfg = TF.FSDPConfig(qcfg=TC.QSyncConfig(q=c["q"], bucket=BUCKET,
                                            packed=c["packed"]),
                        sync=c["sync"], anchored=c["anchored"],
                        anchor_sharded=c["sharded"])
    sizes = [2, 2] if len(c["axes"]) == 2 else [WORLD]
    want = TF.wire_bytes_bwd(M, sizes, cfg)
    assert [int(r[f"{name}/sent"]) for r in ranks] == [want] * WORLD


def test_same_leaf_sync_order_on_every_rank(runs):
    _, _, ranks = runs
    orders = [r["order"] for r in ranks]
    assert orders[0].shape == (3, 2)
    for o in orders[1:]:
        np.testing.assert_array_equal(o, orders[0])


@pytest.mark.parametrize("m,sizes", [(8192, [4]), (8192, [2, 2]),
                                     (1 << 15, [8]), (4096, [1]),
                                     (3 * 2048, [2]), (1 << 14, [2, 4])])
@pytest.mark.parametrize("sync,anchored,sharded,packed",
                         [("lq", False, True, True),
                          ("lq", False, True, False),
                          ("lq", True, True, True),
                          ("lq", True, False, True),
                          ("fp32", False, True, True)])
def test_wire_and_anchor_bytes_equal_reference(m, sizes, sync, anchored,
                                               sharded, packed):
    from repro.dist import collectives as JC
    from repro.dist import fsdp as JF

    for bucket, q in ((512, 16), (64, 4)):
        jc = JF.FSDPConfig(qcfg=JC.QSyncConfig(q=q, bucket=bucket,
                                               packed=packed), sync=sync,
                           anchored=anchored, anchor_sharded=sharded)
        tc = TF.FSDPConfig(qcfg=TC.QSyncConfig(q=q, bucket=bucket,
                                               packed=packed), sync=sync,
                           anchored=anchored, anchor_sharded=sharded)
        for f in ("wire_bytes_bwd", "anchor_bytes_step",
                  "anchor_gather_bytes_fwd"):
            assert getattr(TF, f)(m, sizes, tc) == \
                getattr(JF, f)(m, sizes, jc), (f, bucket)
        dp = int(np.prod(sizes))
        assert TF.leaf_nb(m, dp, tc.qcfg) == JF.leaf_nb(m, dp, jc.qcfg)
        assert TF.tele_width(7, m, anchored) == JF.tele_width(7, m, anchored)
