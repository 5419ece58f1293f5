"""The port's training stack vs the JAX package's (CPU).

In one process: ``lr_at``, ``apply_update`` and ``_y_update`` bitwise
against the reference's compiled step (which contracts mul-adds into FMAs
and divides by a constant through its reciprocal; the port copies both),
the data draw's tokens (bitwise except where the categorical draw's two
logs flip an argmax; the fraction is counted), and checkpoints written by
each package restoring in the other.

At world 4: one JAX subprocess with four emulated CPU devices runs the
reference ``Trainer`` on a (4, 1) mesh for three steps of internvl2-smoke,
and four port ranks over a ``gloo`` group run the port's ``Trainer`` from
the same initial state (``convert.train_state_from_numpy``) on the same
batches (the reference's): the losses agree within bf16 tolerance and the
decode failures are equal.  The port also holds its own pairs bitwise:
serial == prefetch, packed == unpacked telemetry, and a restart from a
checkpoint replays the uninterrupted run.  Each process has its own time
limit.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax compatibility shims)
from repro.configs import registry as JRg
from repro.dist.collectives import QSyncConfig as JQ
from repro.models.sharding import ShardCtx as JCtx
from repro.train import checkpoint as JCk
from repro.train import data as JD
from repro.train import optim as JO
from repro.train import trainer as JTr
from repro_torch.configs import registry as TRg
from repro_torch.dist.collectives import QSyncConfig as TQ
from repro_torch.models.sharding import ShardCtx as TCtx
from repro_torch.train import data as TD
from repro_torch.train import optim as TO
from repro_torch.train import trainer as TTr

ROOT = Path(__file__).resolve().parents[1]
WORLD, STEPS, SEQ, BUCKET = 4, 3, 24, 64
LIMIT_S = 300
ARCH = "internvl2-1b"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# optimizer, y update
# ---------------------------------------------------------------------------

def test_lr_at_bitwise():
    """The schedule as the reference's compiled step computes it."""
    for cfg in (dict(warmup=5, decay_steps=100),
                dict(warmup=100, decay_steps=10_000, lr=1e-3),
                dict(warmup=2, decay_steps=10, lr=1e-2)):
        jf = jax.jit(lambda s, c=JO.OptConfig(**cfg): JO.lr_at(c, s))
        tcfg = TO.OptConfig(**cfg)
        steps = list(range(0, 300)) + list(range(4_900, 5_100)) + [12_000]
        got = np.array([np.float32(TO.lr_at(tcfg, s)) for s in steps])
        want = np.array([np.float32(jf(jnp.asarray(s, jnp.int32)))
                         for s in steps])
        assert _bits(got).tobytes() == _bits(want).tobytes(), cfg


@pytest.mark.parametrize("name", ["adamw", "momentum"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_update_chunked_equals_whole(monkeypatch, name, state_dtype):
    """A leaf larger than ``UPDATE_CHUNK`` is updated over slices of its
    last dim (bounded f64 temporaries): the same bits as in one piece, for
    a stacked (L, 1, 1, shard) leaf and a top-level (1, 1, shard) one."""
    rng = np.random.RandomState(2)
    cfg = TO.OptConfig(name=name, state_dtype=state_dtype, warmup=5,
                       decay_steps=100)
    dt = getattr(torch, state_dtype)
    params = {"s": _t(rng.randn(3, 1, 1, 1000).astype(np.float32)),
              "t": _t(rng.randn(1, 1, 777).astype(np.float32))}
    grads = {k: _t((1e-2 * rng.randn(*v.shape)).astype(np.float32))
             for k, v in params.items()}
    st = {k: {n: _t((1e-3 * rng.rand(*v.shape)).astype(np.float32)).to(dt)
              for n, v in params.items()}
          for k in (("m", "v") if name == "adamw" else ("m",))}
    whole = TO.apply_update(params, grads, st, 7, cfg, torch.tensor(0.4))
    monkeypatch.setattr(TO, "UPDATE_CHUNK", 256)
    parts = TO.apply_update(params, grads, st, 7, cfg, torch.tensor(0.4))
    for a, b in ((whole[0], parts[0]), *((whole[1][k], parts[1][k])
                                         for k in st)):
        for n in params:
            assert torch.equal(a[n].view(torch.int16 if a[n].dtype ==
                                         torch.bfloat16 else torch.int32),
                               b[n].view(torch.int16 if b[n].dtype ==
                                         torch.bfloat16 else torch.int32)), n


@pytest.mark.parametrize("name", ["adamw", "momentum"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_update_bitwise(name, state_dtype):
    """With f32 moments (the default) the update equals the reference's
    compiled update bit for bit, params and moments.  With bf16 moments
    the reference's compiler contracts the moment it stores in another
    order than the one feeding the parameter update (and differently from
    the f32 program); the port keeps the f32 order, so a bf16 moment is
    within one bf16 ulp of the reference's plus two f32 ulps of its
    mul-add's addends (they differ where the products nearly cancel), and
    the params within rtol 1e-6."""
    rng = np.random.RandomState(1)
    n = 50_000
    p = rng.randn(n).astype(np.float32)
    g = (rng.randn(n) * 1e-2).astype(np.float32)
    m = (rng.randn(n) * 1e-3).astype(np.float32)
    v = (rng.rand(n) * 1e-4).astype(np.float32)
    jcfg = JO.OptConfig(name=name, state_dtype=state_dtype, warmup=5,
                        decay_steps=100)
    tcfg = TO.OptConfig(name=name, state_dtype=state_dtype, warmup=5,
                        decay_steps=100)
    jdt, tdt = jnp.dtype(state_dtype), getattr(torch, state_dtype)
    for step in (0, 3, 14, 35, 63):
        gn = np.float32([3.7, 0.3, 1.0][step % 3])
        st = {"m": {"a": m}, "v": {"a": v}}
        if name != "adamw":
            st = {"m": {"a": m}}
        jst = {k: {"a": jnp.asarray(x["a"]).astype(jdt)}
               for k, x in st.items()}
        jp, jo = jax.jit(lambda P, G, S, s, n_: JO.apply_update(
            {"a": P}, {"a": G}, S, s, jcfg, n_))(
                p, g, jst, jnp.asarray(step, jnp.int32), jnp.asarray(gn))
        tst = {k: {"a": _t(x["a"]).to(tdt)} for k, x in st.items()}
        tp, to = TO.apply_update({"a": _t(p)}, {"a": _t(g)}, tst, step, tcfg,
                                 torch.tensor(gn))
        if state_dtype == "float32":
            assert _bits(tp["a"].numpy()).tobytes() == \
                _bits(np.asarray(jp["a"])).tobytes(), (name, step)
        else:
            np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                                       rtol=1e-6, atol=0)
        for k in st:
            got = to[k]["a"].float().numpy()
            want = np.asarray(jo[k]["a"]).astype(np.float32)
            if state_dtype == "float32":
                assert got.tobytes() == want.tobytes(), k
            else:
                old = st[k]["a"]
                gc = g * min(1.0, 1.0 / float(gn))
                addend = (0.9 * np.abs(old) + 0.1 * np.abs(gc) if k == "m"
                          else 0.95 * np.abs(old) + 0.05 * gc * gc)
                lim = (np.spacing(np.abs(want)) * 2.0 ** 16
                       + 2 * np.spacing(addend.astype(np.float32)))
                assert np.all(np.abs(got - want) <= lim), k


def test_y_update_bitwise():
    rng = np.random.RandomState(4)
    nb, L = 16, 3
    tc, jtc = TTr.TrainConfig(), JTr.TrainConfig()
    y = (0.5 + rng.rand(L, nb)).astype(np.float32)
    tele = np.zeros((L, 3 + 2 * nb + 40), np.float32)
    tele[:, 0] = rng.rand(L)
    tele[:, 2] = rng.rand(L)
    tele[:, 3:3 + nb] = rng.rand(L, nb) * 2
    tele[:, 3 + nb:3 + 2 * nb] = rng.rand(L, nb) > 0.8
    tele[:, 3 + 2 * nb:] = rng.randn(L, 40)
    cases = [
        (y, tele),                                            # per bucket
        (y[:, 0], tele[:, :3]),                               # scalar
        ({"y": y, "anchor": np.zeros((L, 1, 1, 40), np.float32)}, tele),
    ]
    for yv, tv in cases:
        jy = jax.tree.map(jnp.asarray, yv)
        want = jax.jit(lambda a, b: JTr._y_update(a, b, jtc))(jy, tv)
        got = TTr._y_update(
            {k: _t(v) for k, v in yv.items()} if isinstance(yv, dict)
            else _t(yv), _t(tv), tc)
        for w, gt in zip(jax.tree.leaves(want),
                         jax.tree.leaves(got if isinstance(got, dict)
                                         else [got])):
            assert _bits(np.asarray(w)).tobytes() == \
                _bits(gt.numpy()).tobytes()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_batch_tokens_against_reference():
    """The tokens of the Markov stream equal the reference's except where
    torch's and XLA's logs round a Gumbel draw an ulp apart and flip its
    argmax: at the smoke vocab none of 4 x 65 draws flip; at 32,768 the
    flipped share stays under 1e-3."""
    for vocab, B, S, limit in ((257, 4, 64, 0.0), (32_768, 2, 127, 1e-3)):
        cfg = dict(vocab=vocab, seq_len=S, global_batch=B, seed=3)
        for step in (0, 5):
            want = JD.batch_at(JD.DataConfig(**cfg), step)
            got = TD.batch_at(TD.DataConfig(**cfg), step, device="cpu")
            flips = np.mean(got["tokens"].numpy() != want["tokens"])
            assert flips <= limit, (vocab, step, flips)
            assert np.mean(got["targets"].numpy() != want["targets"]) <= limit
            np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
            loc = TD.local_batch_at(TD.DataConfig(**cfg), step, 1, 2,
                                    device="cpu")
            h = B // 2
            for k in ("tokens", "targets"):
                assert torch.equal(loc[k], got[k][h:2 * h])
    uni = dict(vocab=97, seq_len=16, global_batch=2, seed=1, kind="uniform")
    np.testing.assert_array_equal(
        TD.batch_at(TD.DataConfig(**uni), 2, device="cpu")["tokens"].numpy(),
        JD.batch_at(JD.DataConfig(**uni), 2)["tokens"])
    fcfg = dict(vocab=97, seq_len=16, global_batch=4)
    want = JD.frames_at(JD.DataConfig(**fcfg), 2, 8, 16)
    got = TD.frames_at(TD.DataConfig(**fcfg), 2, 8, 16, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    rows = TD.frames_at(TD.DataConfig(**fcfg), 2, 8, 16, rows=(1, 3),
                        device="cpu")
    assert torch.equal(rows, got[1:3])


# ---------------------------------------------------------------------------
# checkpoints across the packages (world 1)
# ---------------------------------------------------------------------------

def _jax_trainer(tmp, steps=1):
    cfg = JRg.smoke_config(ARCH)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    data = JD.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2)
    return JTr.Trainer(
        cfg, JCtx(dp=1, qcfg=JQ(q=16, bucket=BUCKET)), mesh,
        JO.OptConfig(lr=1e-2, warmup=2, decay_steps=10),
        JTr.TrainConfig(steps=steps, ckpt_dir=str(tmp), log_every=1),
        data, extra_batch=lambda s: {"img": JD.frames_at(
            data, s, cfg.img_tokens, cfg.d_model)})


def _port_trainer(tmp, steps=1):
    cfg = TRg.smoke_config(ARCH)
    data = TD.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2)
    return TTr.Trainer(
        cfg, TCtx(dp=1, qcfg=TQ(q=16, bucket=BUCKET)),
        TO.OptConfig(lr=1e-2, warmup=2, decay_steps=10),
        TTr.TrainConfig(steps=steps, ckpt_dir=str(tmp), log_every=1), data,
        extra_batch=lambda s: {"img": TD.frames_at(
            data, s, cfg.img_tokens, cfg.d_model, device="cpu")},
        device="cpu")


def _state_tree_bits(params, opt):
    return {f"{g}/{k}": _bits(np.asarray(v)).tobytes()
            for tree in (params, *opt.values()) for g in tree
            for k, v in tree[g].items()}


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo group for the port's world-1 trainer, torn down
    after the test."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_checkpoints_cross_between_packages(tmp_path, one_rank_group):
    """A checkpoint the reference writes restores in the port, and one the
    port writes restores in the reference: the same params, moments, y and
    step, bit for bit."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jtr = _jax_trainer(jdir)
    jstate = jtr.train()                         # one step, then it saves
    ptr = _port_trainer(jdir)
    pstate = ptr.restore()
    assert pstate["step"] == 1 == int(jstate["step"])
    for g in ("layers", "top"):
        for k, v in jstate["params"][g].items():
            assert _bits(np.asarray(v)).tobytes() == \
                _bits(pstate["params"][g][k].numpy()).tobytes(), k
            for mk in ("m", "v"):
                assert np.asarray(jstate["opt"][mk][g][k]).tobytes() == \
                    pstate["opt"][mk][g][k].numpy().tobytes(), (mk, k)
            assert np.asarray(jstate["y"][g][k]).tobytes() == \
                pstate["y"][g][k].numpy().tobytes(), k
    # the port trains on, saves; the reference restores that
    ptr2 = _port_trainer(tdir, steps=2)
    pstate2 = ptr2.train(pstate)
    jtr2 = _jax_trainer(tdir, steps=2)
    jstate2 = jtr2.restore()
    assert int(jstate2["step"]) == 2
    for g in ("layers", "top"):
        for k, v in pstate2["params"][g].items():
            assert _bits(v.numpy()).tobytes() == \
                _bits(np.asarray(jstate2["params"][g][k])).tobytes(), k
            assert pstate2["y"][g][k].numpy().tobytes() == \
                np.asarray(jstate2["y"][g][k]).tobytes(), k


# ---------------------------------------------------------------------------
# world 4: the reference Trainer vs the port's, and the port's own pairs
# ---------------------------------------------------------------------------

_JAX_SCRIPT = """
import json, sys
import numpy as np
import repro  # noqa: F401
import jax
from repro.configs import registry
from repro.dist.collectives import QSyncConfig
from repro.models.sharding import ShardCtx
from repro.train import data as D
from repro.train.optim import OptConfig
from repro.train.trainer import Trainer, TrainConfig

out, ckpt, steps, seq, bucket = sys.argv[1:6]
steps, seq, bucket = int(steps), int(seq), int(bucket)
cfg = registry.smoke_config("internvl2-1b")
mesh = jax.make_mesh((4, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
data = D.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=4)
tr = Trainer(cfg, ShardCtx(dp=4, qcfg=QSyncConfig(q=16, bucket=bucket)),
             mesh, OptConfig(lr=1e-2, warmup=2, decay_steps=10),
             TrainConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=1000,
                         log_every=1), data,
             extra_batch=lambda s: {"img": D.frames_at(data, s, cfg.img_tokens,
                                                       cfg.d_model)})
tr.train()
np.savez(out, loss=[h["loss"] for h in tr.history],
         fails=[h["fails"] for h in tr.history],
         gnorm=[h["gnorm"] for h in tr.history])
"""

_RANK_SCRIPT = """
import datetime, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.launch.mesh import make_groups
from repro_torch.models import transformer as T
from repro_torch.models.sharding import ShardCtx, shard_len
from repro_torch.train import data as D
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import Trainer, TrainConfig

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
inp, out, tmp, steps, seq, bucket = sys.argv[4:10]
steps, seq, bucket = int(steps), int(seq), int(bucket)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
groups = make_groups((world,))
npz = dict(np.load(inp))
cfg = registry.smoke_config("internvl2-1b")
data = D.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=4)

def unflat(prefix):
    tree = {}
    for k, v in npz.items():
        if k.startswith(prefix + "/"):
            parts = k[len(prefix) + 1:].split("/")
            cur = tree
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = v
    return tree

state_np = {"params": unflat("params"), "opt": unflat("opt"),
            "y": unflat("y"), "step": npz["step"], "key": npz["key"]}

def batch(step):
    sl = slice(rank, rank + 1)
    return {k: torch.from_numpy(npz[f"batch{step}/{k}"][sl].copy())
            for k in ("tokens", "targets", "mask", "img")}

def trainer(name, steps=steps, hook=None, ckpt_every=1000, **ctx_kw):
    kw = dict(prefetch=False, qcfg=QSyncConfig(q=16, bucket=bucket))
    kw.update(ctx_kw)
    ctx = ShardCtx(dp=world, dp_axes=groups, **kw)
    tr = Trainer(cfg, ctx, OptConfig(lr=1e-2, warmup=2, decay_steps=10),
                 TrainConfig(steps=steps, ckpt_dir=os.path.join(tmp, name),
                             ckpt_every=ckpt_every, log_every=1),
                 data, failure_hook=hook, device="cpu")
    tr._batch = batch
    return tr

def fresh():
    return convert.train_state_from_numpy(state_np, cfg, ShardCtx(dp=world),
                                          rank, device="cpu")

metas = T.all_metas(cfg, ShardCtx(dp=world))

def flat(state):
    # params (the logical coordinates of the rank's shard: the padding
    # past a leaf's end is not part of the model) and y
    out = {}
    for g in ("layers", "top"):
        for k, v in state["params"][g].items():
            sl = shard_len(metas[g][k], ShardCtx(dp=world))
            real = max(0, min(sl, metas[g][k].numel() - rank * sl))
            out[f"p/{g}/{k}"] = v[..., :real].numpy()
        for k, v in state["y"][g].items():
            out[f"y/{g}/{k}"] = v.numpy()
    return out

res = {}
runs = {}
for name, kw in (("serial", {}), ("prefetch", dict(prefetch=True))):
    tr = trainer(name, **kw)
    st = tr.train(fresh())
    runs[name] = flat(st)
    for f in ("loss", "gnorm", "fails"):
        res[f"{name}/{f}"] = np.asarray([h[f] for h in tr.history])
    res[f"{name}/restarts"] = np.asarray(tr.restarts)
for k, v in runs["serial"].items():
    res["serial/" + k] = v
    res["prefetch/" + k] = runs["prefetch"][k]

# packed vs unpacked telemetry: one step each from the same state
for packed in (True, False):
    tr = trainer(f"packed{packed}", steps=1,
                 qcfg=QSyncConfig(q=16, bucket=bucket, packed=packed))
    st = tr.train(fresh())
    for k, v in flat(st).items():
        res[f"packed{packed}/" + k] = v

# restart: a failure at the last step restores the checkpoint and replays
armed = {"on": True}
def hook(step):
    if step == steps - 1 and armed["on"]:
        armed["on"] = False
        raise RuntimeError("injected failure")
tr = trainer("restart", hook=hook, ckpt_every=steps - 1)
st = tr.train(fresh())
res["restart/restarts"] = np.asarray(tr.restarts)
for k, v in flat(st).items():
    res["restart/" + k] = v
np.savez(out, **res)
dist.destroy_process_group()
"""


def _reference_inputs(path):
    """The reference's initial state (global storage arrays) and its
    batches, flattened into one npz for the port's ranks."""
    cfg = JRg.smoke_config(ARCH)
    ctx = JCtx(dp=WORLD, qcfg=JQ(q=16, bucket=BUCKET))
    state = JTr.init_state(cfg, ctx, JO.OptConfig(), JTr.TrainConfig(),
                           jax.random.PRNGKey(0))
    flat = {}
    for top in ("params", "opt", "y"):
        for k, v in JCk._flatten(jax.tree.map(np.asarray, state[top])).items():
            flat[f"{top}/{k}"] = v
    flat["step"] = np.asarray(state["step"])
    flat["key"] = np.asarray(state["key"])
    data = JD.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=WORLD)
    for s in range(STEPS):
        b = JD.batch_at(data, s)
        b["img"] = JD.frames_at(data, s, cfg.img_tokens, cfg.d_model)
        for k, v in b.items():
            flat[f"batch{s}/{k}"] = v
    np.savez(path, **flat)


def _finish(procs, deadline):
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
    import socket

    tmp = tmp_path_factory.mktemp("train")
    inp = tmp / "inputs.npz"
    _reference_inputs(inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")

    def start(name, script, *args):
        log = tmp / f"{name.replace(' ', '_')}.log"
        with open(log, "w") as f:
            p = subprocess.Popen([sys.executable, "-c", script,
                                  *map(str, args)], env=env, stdout=f,
                                 stderr=subprocess.STDOUT)
        return name, p, log

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [start("jax reference", _JAX_SCRIPT, tmp / "jax.npz",
                   tmp / "jax_ckpt", STEPS, SEQ, BUCKET)]
    procs += [start(f"port rank {r}", _RANK_SCRIPT, r, WORLD, port, inp,
                    tmp / f"rank{r}.npz", tmp / "ckpt", STEPS, SEQ,
                    BUCKET) for r in range(WORLD)]
    _finish(procs, time.monotonic() + LIMIT_S)
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)])


def test_trainer_matches_reference_at_world4(runs):
    """Losses within bf16 tolerance (bf16 compute on both sides, summed in
    other orders), decode failures equal, every rank's loss the same."""
    jres, ranks = runs
    loss = np.stack([r["serial/loss"] for r in ranks])
    assert loss.shape == (WORLD, STEPS) and np.all(np.isfinite(loss))
    assert all(_bits(l).tobytes() == _bits(loss[0]).tobytes() for l in loss)
    np.testing.assert_allclose(loss[0], jres["loss"], rtol=2e-2)
    np.testing.assert_array_equal(ranks[0]["serial/fails"], jres["fails"])
    np.testing.assert_allclose(ranks[0]["serial/gnorm"], jres["gnorm"],
                               rtol=5e-2)


def test_serial_equals_prefetch_bitwise(runs):
    _, ranks = runs
    for r in ranks:
        for k in r:
            if k.startswith("serial/") and k != "serial/restarts":
                assert _bits(r[k]).tobytes() == \
                    _bits(r["prefetch/" + k[7:]]).tobytes(), k


def test_packed_telemetry_equals_unpacked(runs):
    _, ranks = runs
    for r in ranks:
        keys = [k for k in r if k.startswith("packedTrue/")]
        assert keys
        for k in keys:
            assert _bits(r[k]).tobytes() == \
                _bits(r["packedFalse/" + k[11:]]).tobytes(), k


def test_restart_replays_bitwise(runs):
    """The restarted run's parameters (their logical coordinates) and y
    equal the uninterrupted run's.  The padding past a leaf's end is left
    out: its gradient is the quantized mean of zeros, which the dither
    makes nonzero, so it drifts, and a checkpoint, which stores logical
    tensors (as the reference's does), restores it as zeros; it never
    reaches the model."""
    _, ranks = runs
    for r in ranks:
        assert int(r["restart/restarts"]) == 1
        assert int(r["serial/restarts"]) == 0
        for k in r:
            if k.startswith("restart/p/") or k.startswith("restart/y/"):
                assert _bits(r[k]).tobytes() == \
                    _bits(r["serial/" + k[8:]]).tobytes(), k


# ---------------------------------------------------------------------------
# the launcher: runs without --ckpt-dir share no state
# ---------------------------------------------------------------------------

def test_launches_without_ckpt_dir_share_no_state(tmp_path):
    """Two launches at once with the default checkpoint directory each
    train from step 0 into a fresh directory under their TMPDIR (both
    ranks save into rank 0's), so neither resumes from nor overwrites the
    other's checkpoints."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--mesh", "2x1", "--batch", "2", "--seq", "16",
           "--steps", "2", "--log-every", "1", "--device", "cpu"]
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out[-10000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dirs, losses = [], []
    for out in outs:
        lines = out.splitlines()
        assert [ln.split()[1] for ln in lines
                if ln.startswith("[train] step=")] == ["step=0", "step=1"]
        losses.append([ln.split()[2] for ln in lines
                       if ln.startswith("[train] step=")])
        dirs += [ln.split()[-1] for ln in lines
                 if ln.startswith("[train] checkpoints in ")]
    assert len(dirs) == 2 and dirs[0] != dirs[1]
    assert losses[0] == losses[1]
    for d in dirs:
        assert Path(d).parent == tmp_path
        assert sorted(x.name for x in Path(d).iterdir()) == ["step_00000002"]
