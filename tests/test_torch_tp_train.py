"""Training on a (dp 2, tp 2) mesh: the port vs the JAX package (CPU).

One JAX subprocess with four emulated CPU devices runs, on a (2, 2) mesh:

* the reference ``Trainer`` for three steps of internvl2-smoke with
  sequence parallelism and the quantized TP psum of replicated leaves'
  gradients (lq sync, q = 16, bucket 64);
* one step of a 2-layer dense model with the f32 gradient sync, with and
  without sequence parallelism: the loss and the logical gradients.

Four port ranks over a ``gloo`` group (``launch/mesh.mesh_axes((2, 2))``)
run the same from the same initial state and batches, and the dense step
also at (4, 1), the port without TP.  Held:

* the trainer's losses within rtol 2e-2, gnorm within 5e-2, decode
  failures equal (bf16 compute on both sides, summed in other orders);
* the dense step's loss within 2e-2 and every gradient within 5e-2 of its
  largest entry, against the reference at (2, 2) and against the port at
  tp = 1 (``tests/test_multidevice.py``'s tolerances);
* bitwise, the port's own pairs: serial == prefetch, packed == unpacked
  telemetry, and every replicated leaf (params, moments, y) equal on the
  two TP ranks of a DP group after the run;
* the checkpoint the port writes at (2, 2), read by the reference's loader
  and converted by either package, gives every rank's parameters back
  bit for bit (their logical coordinates).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax compatibility shims)
from repro.configs import registry as JRg
from repro.dist.collectives import QSyncConfig as JQ
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JMC
from repro.train import checkpoint as JCk
from repro.train import data as JD
from repro.train import optim as JO
from repro.train import trainer as JTr
from repro_torch.dist.collectives import QSyncConfig as TQ
from repro_torch.models import sharding as TS
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TMC
from repro_torch.train import checkpoint as TCk

ROOT = Path(__file__).resolve().parents[1]
STEPS, SEQ, BUCKET, LIMIT_S = 3, 24, 64, 300
ARCH = "internvl2-1b"
DENSE = dict(arch="t", family="dense", n_layers=2, d_model=32, n_heads=8,
             n_kv=4, head_dim=8, d_ff=64, vocab=96, act="swiglu")


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _jctx(**kw):
    return JS.ShardCtx(tp=2, dp=2, qcfg=JQ(q=16, bucket=BUCKET),
                       seq_parallel=True, quantize_tp_grads=True, **kw)


def _dense_logical(seed=0):
    """Logical layer stacks and top tensors of the dense model (tp 1)."""
    cfg, c1 = JMC(**DENSE), JS.ShardCtx()
    rng = np.random.RandomState(seed)
    out = {"layers": {}, "top": {}}
    for grp, metas in JT.all_metas(cfg, c1).items():
        for name, meta in sorted(metas.items()):
            shp = JS.logical_shape(meta, c1)
            if meta.scanned:
                shp = (cfg.n_layers,) + tuple(shp)
            out[grp][name] = (np.ones(shp, np.float32) if meta.init == "ones"
                              else (0.05 * rng.randn(*shp)).astype(np.float32))
    return out


def _reference_inputs(path):
    cfg = JRg.smoke_config(ARCH)
    state = JTr.init_state(cfg, _jctx(), JO.OptConfig(), JTr.TrainConfig(),
                           jax.random.PRNGKey(0))
    flat = {}
    for top in ("params", "opt", "y"):
        for k, v in JCk._flatten(jax.tree.map(np.asarray, state[top])).items():
            flat[f"{top}/{k}"] = v
    flat["step"] = np.asarray(state["step"])
    flat["key"] = np.asarray(state["key"])
    data = JD.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2)
    for s in range(STEPS):
        b = JD.batch_at(data, s)
        b["img"] = JD.frames_at(data, s, cfg.img_tokens, cfg.d_model)
        for k, v in b.items():
            flat[f"batch{s}/{k}"] = v
    for grp, leaves in _dense_logical().items():
        for k, v in leaves.items():
            flat[f"dense/{grp}/{k}"] = v
    rng = np.random.RandomState(1)
    flat["dense_tokens"] = rng.randint(0, 96, (4, 16)).astype(np.int32)
    flat["dense_targets"] = rng.randint(0, 96, (4, 16)).astype(np.int32)
    np.savez(path, **flat)


_JAX_SCRIPT = """
import sys
from functools import partial
import numpy as np
import repro  # noqa: F401
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.dist.collectives import QSyncConfig
from repro.models import transformer as T
from repro.models.config import ModelConfig
from repro.models.sharding import (ShardCtx, logical_to_storage,
                                   storage_spec, storage_to_logical)
from repro.train import data as D
from repro.train.optim import OptConfig
from repro.train.trainer import Trainer, TrainConfig

inp, out, ckpt, steps, seq, bucket = sys.argv[1:7]
steps, seq, bucket = int(steps), int(seq), int(bucket)
z = dict(np.load(inp))
res = {}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = registry.smoke_config("internvl2-1b")
data = D.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)
ctx = ShardCtx(tp=2, dp=2, qcfg=QSyncConfig(q=16, bucket=bucket),
               seq_parallel=True, quantize_tp_grads=True)
tr = Trainer(cfg, ctx, mesh, OptConfig(lr=1e-2, warmup=2, decay_steps=10),
             TrainConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=1000,
                         log_every=1), data,
             extra_batch=lambda s: {"img": D.frames_at(data, s, cfg.img_tokens,
                                                       cfg.d_model)})
tr.train()
for f in ("loss", "gnorm", "fails"):
    res[f"trainer/{f}"] = np.asarray([h[f] for h in tr.history])

kw = dict(arch="t", family="dense", n_layers=2, d_model=32, n_heads=8,
          n_kv=4, head_dim=8, d_ff=64, vocab=96, act="swiglu")
dcfg = ModelConfig(**kw)
lp = {g: {k[len("dense/") + len(g) + 1:]: v for k, v in z.items()
          if k.startswith(f"dense/{g}/")} for g in ("layers", "top")}
batch = {"tokens": z["dense_tokens"], "targets": z["dense_targets"],
         "mask": np.ones((4, 16), np.float32)}
for sp in (False, True):
    dctx = ShardCtx(tp=2, dp=2, qcfg=QSyncConfig(q=256, bucket=32),
                    grad_sync="fp32", seq_parallel=sp)
    metas = T.all_metas(dcfg, dctx)
    params = {"layers": {k: jax.vmap(lambda x, m=m: logical_to_storage(
                  x, m, dctx))(lp["layers"][k])
                  for k, m in metas["layers"].items()},
              "top": {k: logical_to_storage(lp["top"][k], m, dctx)
                      for k, m in metas["top"].items()}}
    pspec = {g: {k: storage_spec(m, dctx) for k, m in metas[g].items()}
             for g in metas}
    loss_fn = T.make_loss_fn(dcfg, dctx)
    y = T.y_init(dcfg, dctx, 50.0)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(pspec, P(), {k: P("data") for k in batch}, P()),
             out_specs=(P(), pspec), check_vma=False)
    def step(params, key, batch, y):
        tele = T.tele_zeros(dcfg, dctx)
        (l, m), g = jax.value_and_grad(loss_fn, has_aux=True)(
            params, tele, batch, key, y)
        return jax.lax.psum(m["loss"], ("data",)) / dctx.dp, g
    bp = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
          for k, v in batch.items()}
    pp = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                      params, pspec)
    loss, g = jax.jit(step)(pp, jax.random.PRNGKey(3), bp, y)
    res[f"dense/{sp}/loss"] = np.asarray(loss)
    for k in g["layers"]:
        res[f"dense/{sp}/layers/{k}"] = np.asarray(jax.vmap(
            lambda x: storage_to_logical(x, metas["layers"][k], dctx))(
                g["layers"][k]))
    for k in g["top"]:
        res[f"dense/{sp}/top/{k}"] = np.asarray(storage_to_logical(
            g["top"][k], metas["top"][k], dctx))
np.savez(out, **res)
"""

_RANK_SCRIPT = """
import datetime, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert, random as R
from repro_torch.configs import registry
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.launch.mesh import make_groups, mesh_axes
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardCtx, shard_len
from repro_torch.train import checkpoint as C
from repro_torch.train import data as D
from repro_torch.train import trainer as TR
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import Trainer, TrainConfig

rank, port, inp, out, tmp, steps, seq, bucket = sys.argv[1:9]
rank, steps, seq, bucket = int(rank), int(steps), int(seq), int(bucket)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
dp_axes, tp_axis = mesh_axes((2, 2))
dp_idx, tp_idx = rank // 2, rank % 2
z = dict(np.load(inp))
cfg = registry.smoke_config("internvl2-1b")
data = D.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)

def unflat(prefix):
    tree = {}
    for k, v in z.items():
        if k.startswith(prefix + "/"):
            parts = k[len(prefix) + 1:].split("/")
            cur = tree
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = v
    return tree

state_np = {"params": unflat("params"), "opt": unflat("opt"),
            "y": unflat("y"), "step": z["step"], "key": z["key"]}

def ctx_of(**kw):
    base = dict(tp=2, dp=2, dp_axes=dp_axes, tp_axis=tp_axis,
                qcfg=QSyncConfig(q=16, bucket=bucket), seq_parallel=True,
                quantize_tp_grads=True)
    base.update(kw)
    return ShardCtx(**base)

def batch(step):
    sl = slice(dp_idx, dp_idx + 1)
    return {k: torch.from_numpy(z[f"batch{step}/{k}"][sl].copy())
            for k in ("tokens", "targets", "mask", "img")}

def trainer(name, steps=steps, **kw):
    tr = Trainer(cfg, ctx_of(**kw),
                 OptConfig(lr=1e-2, warmup=2, decay_steps=10),
                 TrainConfig(steps=steps, ckpt_dir=os.path.join(tmp, name),
                             ckpt_every=1000, log_every=1),
                 data, device="cpu")
    tr._batch = batch
    return tr

def fresh():
    return convert.train_state_from_numpy(state_np, cfg, ctx_of(), dp_idx,
                                          device="cpu", tp_rank=tp_idx)

metas = T.all_metas(cfg, ctx_of())

def flat(state):
    out = {}
    for g in ("layers", "top"):
        for k, v in state["params"][g].items():
            sl = shard_len(metas[g][k], ctx_of())
            real = max(0, min(sl, metas[g][k].numel() - dp_idx * sl))
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
    if name == "serial":
        for g in ("layers", "top"):
            for k, m in metas[g].items():
                if m.tp_replicated:
                    res[f"repl/p/{g}/{k}"] = st["params"][g][k].numpy()
                    res[f"repl/y/{g}/{k}"] = st["y"][g][k].numpy()
                    for mk, mv in st["opt"].items():
                        res[f"repl/{mk}/{g}/{k}"] = mv[g][k].numpy()
for k, v in runs["serial"].items():
    res["serial/" + k] = v
    res["prefetch/" + k] = runs["prefetch"][k]

for packed in (True, False):
    tr = trainer(f"packed{packed}", steps=1,
                 qcfg=QSyncConfig(q=16, bucket=bucket, packed=packed))
    for k, v in flat(tr.train(fresh())).items():
        res[f"packed{packed}/" + k] = v

# the dense model, one step with the f32 sync, at (2, 2) with and without
# sequence parallelism and at (4, 1)
dcfg = ModelConfig(arch="t", family="dense", n_layers=2, d_model=32,
                   n_heads=8, n_kv=4, head_dim=8, d_ff=64, vocab=96,
                   act="swiglu")
lp = {g: {k[len("dense/") + len(g) + 1:]: v for k, v in z.items()
          if k.startswith(f"dense/{g}/")} for g in ("layers", "top")}
toks, tgts = z["dense_tokens"], z["dense_targets"]
for name, (dp, tp, sp) in (("tp2", (2, 2, False)), ("tp2sp", (2, 2, True)),
                           ("tp1", (4, 1, False))):
    if tp == 2:
        dctx = ShardCtx(tp=2, dp=2, dp_axes=dp_axes, tp_axis=tp_axis,
                        qcfg=QSyncConfig(q=256, bucket=32), grad_sync="fp32",
                        seq_parallel=sp)
        d_i, t_i = dp_idx, tp_idx
    else:
        dctx = ShardCtx(dp=4, dp_axes=make_groups((4,)),
                        qcfg=QSyncConfig(q=256, bucket=32), grad_sync="fp32")
        d_i, t_i = rank, 0
    dm = T.all_metas(dcfg, dctx)
    params = C.logical_to_params(lp, dm, dctx, d_i, "cpu", t_i)
    b_loc = 4 // dp
    rows = slice(d_i * b_loc, (d_i + 1) * b_loc)
    b = {"tokens": torch.from_numpy(toks[rows].copy()),
         "targets": torch.from_numpy(tgts[rows].copy()),
         "mask": torch.ones((b_loc, 16))}
    p_in = TR._leaves(params, dcfg.n_layers)
    t_in = TR._leaves(T.tele_zeros(dcfg, dctx, device="cpu"), dcfg.n_layers)
    loss, m = T.make_loss_fn(dcfg, dctx)(
        p_in, t_in, b, R.PRNGKey(3), T.y_init(dcfg, dctx, 50.0, device="cpu"))
    loss.backward()
    res[f"dense/{name}/loss"] = (TR.psum_dp(m["loss"].reshape(1), dctx)[0]
                                 / dctx.dp).numpy()
    for g, tree in TR._grads(p_in).items():
        for k, v in tree.items():
            res[f"dense/{name}/{g}/{k}"] = v.numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""


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

    tmp = tmp_path_factory.mktemp("tp_train")
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
    procs = [start("jax reference", _JAX_SCRIPT, inp, tmp / "jax.npz",
                   tmp / "jax_ckpt", STEPS, SEQ, BUCKET)]
    procs += [start(f"port rank {r}", _RANK_SCRIPT, r, port, inp,
                    tmp / f"rank{r}.npz", tmp / "ckpt", STEPS, SEQ, BUCKET)
              for r in range(4)]
    _finish(procs, time.monotonic() + LIMIT_S)
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)], tmp)


def test_trainer_matches_reference_at_2x2(runs):
    """Losses within rtol 2e-2, gnorm within 5e-2, failures equal; every
    rank's loss and gnorm the same bits."""
    jres, ranks, _ = runs
    loss = np.stack([r["serial/loss"] for r in ranks])
    assert loss.shape == (4, STEPS) and np.all(np.isfinite(loss))
    for f in ("loss", "gnorm"):
        for r in ranks:
            assert _bits(r[f"serial/{f}"]).tobytes() == \
                _bits(ranks[0][f"serial/{f}"]).tobytes(), f
    np.testing.assert_allclose(loss[0], jres["trainer/loss"], rtol=2e-2)
    np.testing.assert_allclose(ranks[0]["serial/gnorm"], jres["trainer/gnorm"],
                               rtol=5e-2)
    np.testing.assert_array_equal(ranks[0]["serial/fails"],
                                  jres["trainer/fails"])


def _port_logical(ranks, name, cfg_kw, tp, dp, **ctx_kw):
    """The ranks' gradient slices of one dense run as logical tensors."""
    cfg = TMC(**cfg_kw)
    ctx = TS.ShardCtx(tp=tp, dp=dp, qcfg=TQ(q=256, bucket=32), **ctx_kw)
    out = {}
    for g, metas in TT.all_metas(cfg, ctx).items():
        for k, m in metas.items():
            parts = [r[f"dense/{name}/{g}/{k}"] for r in ranks]
            glob = np.zeros(parts[0].shape[:-3] + (tp, dp, parts[0].shape[-1]),
                            np.float32)
            for i, p in enumerate(parts):
                glob[..., i % tp, i // tp, :] = p[..., 0, 0, :]
            if m.scanned:
                out[f"{g}/{k}"] = np.stack([TS.storage_to_logical(
                    torch.from_numpy(glob[l]), m, ctx).numpy()
                    for l in range(glob.shape[0])])
            else:
                out[f"{g}/{k}"] = TS.storage_to_logical(
                    torch.from_numpy(glob), m, ctx).numpy()
    return out


@pytest.mark.parametrize("sp", [False, True])
def test_dense_step_matches_reference_and_tp1(runs, sp):
    """Loss within 2e-2 and each gradient within 5e-2 of its largest entry,
    against the reference at the same mesh and the port at tp = 1."""
    jres, ranks, _ = runs
    name = "tp2sp" if sp else "tp2"
    got = _port_logical(ranks, name, DENSE, 2, 2)
    tp1 = _port_logical(ranks, "tp1", DENSE, 1, 4)
    l_port = float(ranks[0][f"dense/{name}/loss"])
    assert all(float(r[f"dense/{name}/loss"]) == l_port for r in ranks)
    assert abs(l_port - float(jres[f"dense/{sp}/loss"])) < 2e-2
    assert abs(l_port - float(ranks[0]["dense/tp1/loss"])) < 2e-2
    for k, v in got.items():
        want = jres[f"dense/{sp}/{k}"]
        assert v.shape == want.shape == tp1[k].shape, k
        scale = np.max(np.abs(want)) + 1e-9
        assert np.max(np.abs(v - want)) / scale < 5e-2, k
        assert np.max(np.abs(v - tp1[k])) / scale < 5e-2, k


def test_serial_equals_prefetch_bitwise(runs):
    _, ranks, _ = runs
    for r in ranks:
        keys = [k for k in r if k.startswith("serial/")]
        assert len(keys) > 6
        for k in keys:
            assert _bits(r[k]).tobytes() == \
                _bits(r["prefetch/" + k[7:]]).tobytes(), k


def test_packed_telemetry_equals_unpacked(runs):
    _, ranks, _ = runs
    for r in ranks:
        keys = [k for k in r if k.startswith("packedTrue/")]
        assert keys
        for k in keys:
            assert _bits(r[k]).tobytes() == \
                _bits(r["packedFalse/" + k[11:]]).tobytes(), k


def test_replicated_leaves_equal_across_tp_ranks(runs):
    """After three steps every replicated leaf (wk, wv, the norms) holds
    the same params, moments and y on the two TP ranks of a DP group."""
    _, ranks, _ = runs
    keys = [k for k in ranks[0] if k.startswith("repl/p/")]
    assert any(k.endswith("/wk") for k in keys)
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        for k in a:
            if k.startswith("repl/"):
                assert _bits(a[k]).tobytes() == _bits(b[k]).tobytes(), (d, k)


def test_checkpoint_at_2x2_reads_back_in_both_packages(runs):
    """The serial run's checkpoint (written by rank 0 from every rank's
    shards) holds the logical tensors; converted back by either package it
    gives each rank's final parameters, bit for bit on their logical
    coordinates."""
    _, ranks, tmp = runs
    tree, meta = JCk.load(str(tmp / "ckpt" / "serial"))
    assert meta["step"] == STEPS
    jctx = _jctx()
    tctx = TS.ShardCtx(tp=2, dp=2, qcfg=TQ(q=16, bucket=BUCKET),
                       seq_parallel=True, quantize_tp_grads=True)
    jm = JT.all_metas(JRg.smoke_config(ARCH), jctx)
    tm = TT.all_metas(JRg.smoke_config(ARCH), tctx)
    jp = JCk.logical_to_params(tree["params"], jm, jctx)
    for i, r in enumerate(ranks):
        t, d = i % 2, i // 2
        tp_ = TCk.logical_to_params(tree["params"], tm, tctx, d, "cpu", t)
        for g in ("layers", "top"):
            for k, m in tm[g].items():
                want = r[f"serial/p/{g}/{k}"]
                real = want.shape[-1]
                a = np.asarray(jp[g][k])[..., t:t + 1, d:d + 1, :real]
                assert _bits(a).tobytes() == _bits(want).tobytes(), (i, k)
                assert _bits(tp_[g][k].numpy()[..., :real]).tobytes() == \
                    _bits(want).tobytes(), (i, k)
