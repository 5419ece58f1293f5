"""The MoE family on a TP mesh: the port vs the JAX package (CPU).

One JAX subprocess with four emulated CPU devices runs, on (1, 2) and
(2, 2) meshes (``data``, ``model``):

* the tiled all-to-all of ``repro.models.moe`` (``jax.lax.all_to_all``,
  split 0 / concat 1 and split 1 / concat 0) on seeded rows, and its
  backward (``jax.vjp`` with a seeded cotangent);
* the MoE layer (``transformer._moe_apply``) at f32, with sequence
  parallelism and without (tokens sliced over TP, gathered back): its
  output, ``aux`` and the gradients of its input and weights;
* at (2, 2), the reference ``Trainer`` for three steps of
  granite-moe-smoke with sequence parallelism, experts split over the TP
  ranks and the quantized TP psum of the replicated leaves' gradients.

Four port ranks over a ``gloo`` group (``launch/mesh.mesh_axes((2, 2))``;
the (1, 2) mesh is each of its TP pairs) run the same.  Held: the
all-to-all and its backward bitwise; the MoE layer within rtol 1e-5 at
f32; the trainer's losses within rtol 2e-2, gnorm within 5e-2, decode
failures equal (``tests/test_torch_tp_train.py``'s tolerances), every
rank's gnorm the same bits and the replicated leaves (the router among
them) bitwise equal on the two TP ranks of a DP group.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

import repro  # noqa: F401  (jax compatibility shims)
from repro.configs import registry as JRg
from repro.dist.collectives import QSyncConfig as JQ
from repro.models import sharding as JS
from repro.train import checkpoint as JCk
from repro.train import data as JD
from repro.train import optim as JO
from repro.train import trainer as JTr

ROOT = Path(__file__).resolve().parents[1]
STEPS, SEQ, BUCKET, LIMIT_S = 3, 24, 64, 300
ARCH = "granite-moe-1b-a400m"
E, C, D = 8, 8, 16              # the all-to-all's rows
S_MOE = 24                       # tokens per DP rank of the MoE layer check


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _reference_inputs(path):
    cfg = JRg.smoke_config(ARCH)
    ctx = JS.ShardCtx(tp=2, dp=2, qcfg=JQ(q=16, bucket=BUCKET),
                      seq_parallel=True, quantize_tp_grads=True)
    state = JTr.init_state(cfg, ctx, JO.OptConfig(), JTr.TrainConfig(),
                           jax.random.PRNGKey(0))
    flat = {}
    for top in ("params", "opt", "y"):
        for k, v in JCk._flatten(jax.tree.map(np.asarray, state[top])).items():
            flat[f"{top}/{k}"] = v
    flat["step"] = np.asarray(state["step"])
    flat["key"] = np.asarray(state["key"])
    data = JD.DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2)
    for s in range(STEPS):
        for k, v in JD.batch_at(data, s).items():
            flat[f"batch{s}/{k}"] = v
    rng = np.random.RandomState(0)
    dm, F = cfg.d_model, cfg.d_ff
    flat["a2a_x"] = rng.randn(2, 2, E, C, D).astype(np.float32)
    flat["a2a_y"] = rng.randn(2, 2, E // 2, 2 * C, D).astype(np.float32)
    flat["a2a_gx"] = rng.randn(2, 2, E // 2, 2 * C, D).astype(np.float32)
    flat["a2a_gy"] = rng.randn(2, 2, E, C, D).astype(np.float32)
    flat["moe_x"] = rng.randn(2, S_MOE, dm).astype(np.float32)
    flat["moe_ct"] = rng.randn(2, 2, S_MOE, dm).astype(np.float32)
    flat["moe_router"] = (rng.randn(dm, cfg.n_experts) / 4).astype(np.float32)
    for k, shp in (("w1", (dm, F)), ("w3", (dm, F)), ("w2", (F, dm))):
        flat[f"moe_{k}"] = (rng.randn(cfg.n_experts, *shp) /
                            np.sqrt(shp[0])).astype(np.float32)
    np.savez(path, **flat)


_JAX_SCRIPT = """
import sys
from functools import partial
import numpy as np
import repro  # noqa: F401
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import registry
from repro.dist.collectives import QSyncConfig
from repro.models import transformer as T
from repro.models.sharding import ShardCtx
from repro.train import data as D
from repro.train.optim import OptConfig
from repro.train.trainer import Trainer, TrainConfig

inp, out, ckpt, steps, seq, bucket = sys.argv[1:7]
steps, seq, bucket = int(steps), int(seq), int(bucket)
z = dict(np.load(inp))
res = {}
cfg = registry.smoke_config("granite-moe-1b-a400m")
DM = P("data", "model")

for dp in (1, 2):
    mesh = jax.make_mesh((dp, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:2 * dp])

    @partial(jax.shard_map, mesh=mesh, in_specs=(DM,) * 4,
             out_specs=(DM,) * 4, check_vma=False)
    def a2a(x, y, gx, gy):
        f = lambda v: jax.lax.all_to_all(v, "model", 0, 1, tiled=True)
        b = lambda v: jax.lax.all_to_all(v, "model", 1, 0, tiled=True)
        ox, vx = jax.vjp(f, x[0, 0])
        oy, vy = jax.vjp(b, y[0, 0])
        return (ox[None, None], vx(gx[0, 0])[0][None, None],
                oy[None, None], vy(gy[0, 0])[0][None, None])
    outs = jax.jit(a2a)(*(z[k][:dp] for k in
                          ("a2a_x", "a2a_y", "a2a_gx", "a2a_gy")))
    for name, v in zip(("fx", "bx", "fy", "by"), outs):
        res[f"a2a/{dp}/{name}"] = np.asarray(v)

    for sp in (False, True):
        ctx = ShardCtx(tp=2, dp=dp, seq_parallel=sp)
        xspec = P("data", "model") if sp else P("data")
        wspec = {"router": P(), "w1": P("model"), "w3": P("model"),
                 "w2": P("model")}

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(xspec, wspec, DM),
                 out_specs=(DM, DM, DM, {k: DM for k in wspec}),
                 check_vma=False)
        def moe(x, w, ct):
            (o, aux), vjp = jax.vjp(
                lambda x, w: T._moe_apply(x, w, cfg, ctx), x, w)
            ct = ct[0, 0][None]
            if sp:
                ct = jax.lax.dynamic_slice_in_dim(
                    ct, jax.lax.axis_index("model") * (ct.shape[1] // 2),
                    ct.shape[1] // 2, 1)
            gx, gw = vjp((ct, jnp.ones((), jnp.float32)))
            return (o[None], aux[None, None], gx[None],
                    {k: v[None, None] for k, v in gw.items()})
        w = {k: z[f"moe_{k}"] for k in wspec}
        o, aux, gx, gw = jax.jit(moe)(z["moe_x"][:dp], w, z["moe_ct"][:dp])
        tag = f"moe/{dp}/{sp}"
        res[f"{tag}/out"], res[f"{tag}/aux"] = np.asarray(o), np.asarray(aux)
        res[f"{tag}/gx"] = np.asarray(gx)
        for k, v in gw.items():
            res[f"{tag}/g_{k}"] = np.asarray(v)

mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
data = D.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)
ctx = ShardCtx(tp=2, dp=2, qcfg=QSyncConfig(q=16, bucket=bucket),
               seq_parallel=True, quantize_tp_grads=True)
tr = Trainer(cfg, ctx, mesh, OptConfig(lr=1e-2, warmup=2, decay_steps=10),
             TrainConfig(steps=steps, ckpt_dir=ckpt, ckpt_every=1000,
                         log_every=1), data)
tr.train()
for f in ("loss", "gnorm", "fails"):
    res[f"trainer/{f}"] = np.asarray([h[f] for h in tr.history])
np.savez(out, **res)
"""

_RANK_SCRIPT = """
import datetime, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.train import data as D
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
cfg = registry.smoke_config("granite-moe-1b-a400m")
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
res = {}

for dp in (1, 2):
    d_i = dp_idx if dp == 2 else 0     # (1, 2): each TP pair is the mesh
    ctx = S.ShardCtx(tp=2, dp=dp, dp_axes=dp_axes, tp_axis=tp_axis)
    x = t(z["a2a_x"][d_i, tp_idx]).requires_grad_()
    y = t(z["a2a_y"][d_i, tp_idx]).requires_grad_()
    fx = S.all_to_all_tp(x, ctx, 0, 1)
    fy = S.all_to_all_tp(y, ctx, 1, 0)
    (torch.sum(fx * t(z["a2a_gx"][d_i, tp_idx])) +
     torch.sum(fy * t(z["a2a_gy"][d_i, tp_idx]))).backward()
    for name, v in (("fx", fx), ("bx", x.grad), ("fy", fy), ("by", y.grad)):
        res[f"a2a/{dp}/{name}"] = v.detach().numpy()

    for sp in (False, True):
        ctx = S.ShardCtx(tp=2, dp=dp, dp_axes=dp_axes, tp_axis=tp_axis,
                         seq_parallel=sp)
        xs = z["moe_x"][d_i:d_i + 1]
        ct = z["moe_ct"][d_i, tp_idx][None]
        if sp:
            h = xs.shape[1] // 2
            xs = xs[:, tp_idx * h:(tp_idx + 1) * h]
            ct = ct[:, tp_idx * h:(tp_idx + 1) * h]
        xt = t(xs).requires_grad_()
        e_loc = cfg.n_experts // 2
        w = {k: t(z[f"moe_{k}"] if k == "router" else
                  z[f"moe_{k}"][tp_idx * e_loc:(tp_idx + 1) * e_loc]
                  ).requires_grad_() for k in ("router", "w1", "w3", "w2")}
        o, aux = T._moe_apply(xt, w, cfg, ctx)
        (torch.sum(o * t(ct)) + aux).backward()
        tag = f"moe/{dp}/{sp}"
        res[f"{tag}/out"], res[f"{tag}/aux"] = o.detach().numpy(), \\
            aux.detach().numpy()
        res[f"{tag}/gx"] = xt.grad.numpy()
        for k, v in w.items():
            res[f"{tag}/g_{k}"] = v.grad.numpy()

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
ctx = S.ShardCtx(tp=2, dp=2, dp_axes=dp_axes, tp_axis=tp_axis,
                 qcfg=QSyncConfig(q=16, bucket=bucket), seq_parallel=True,
                 quantize_tp_grads=True)
data = D.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)
tr = Trainer(cfg, ctx, OptConfig(lr=1e-2, warmup=2, decay_steps=10),
             TrainConfig(steps=steps, ckpt_dir=os.path.join(tmp, "ckpt"),
                         ckpt_every=1000, log_every=1), data, device="cpu")
tr._batch = lambda step: {
    k: torch.from_numpy(z[f"batch{step}/{k}"][dp_idx:dp_idx + 1].copy())
    for k in ("tokens", "targets", "mask")}
st = tr.train(convert.train_state_from_numpy(state_np, cfg, ctx, dp_idx,
                                             device="cpu", tp_rank=tp_idx))
for f in ("loss", "gnorm", "fails"):
    res[f"trainer/{f}"] = np.asarray([h[f] for h in tr.history])
for g in ("layers", "top"):
    for k, m in tr.metas[g].items():
        if m.tp_replicated:
            res[f"repl/p/{g}/{k}"] = st["params"][g][k].numpy()
            res[f"repl/y/{g}/{k}"] = st["y"][g][k].numpy()
            for mk, mv in st["opt"].items():
                res[f"repl/{mk}/{g}/{k}"] = mv[g][k].numpy()
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

    tmp = tmp_path_factory.mktemp("moe_tp")
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
                    tmp / f"rank{r}.npz", tmp, STEPS, SEQ, BUCKET)
              for r in range(4)]
    _finish(procs, time.monotonic() + LIMIT_S)
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)])


def _rank_of(dp, r):
    """(dp index, tp index) of port rank r in the reference's arrays of a
    (dp, 2) mesh (at dp = 1 both TP pairs are that mesh)."""
    return (r // 2 if dp == 2 else 0), r % 2


@pytest.mark.parametrize("dp", [1, 2])
def test_all_to_all_and_backward_bitwise(runs, dp):
    jres, ranks = runs
    for r, res in enumerate(ranks):
        d, t = _rank_of(dp, r)
        for name in ("fx", "bx", "fy", "by"):
            want = jres[f"a2a/{dp}/{name}"][d, t]
            got = res[f"a2a/{dp}/{name}"]
            assert got.shape == want.shape, (name, got.shape, want.shape)
            assert _bits(got).tobytes() == _bits(want).tobytes(), (r, name)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("dp", [1, 2])
def test_moe_layer_on_the_mesh_f32(runs, dp, sp):
    """Output, aux and gradients within rtol 1e-5 at f32."""
    jres, ranks = runs
    tag = f"moe/{dp}/{sp}"
    for r, res in enumerate(ranks):
        d, t = _rank_of(dp, r)
        for name in ("out", "gx"):
            want = jres[f"{tag}/{name}"][d, t]
            np.testing.assert_allclose(res[f"{tag}/{name}"].reshape(
                                           want.shape), want,
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        assert abs(float(res[f"{tag}/aux"]) -
                   float(jres[f"{tag}/aux"][d, t])) <= 1e-6
        for k in ("router", "w1", "w3", "w2"):
            np.testing.assert_allclose(res[f"{tag}/g_{k}"],
                                       jres[f"{tag}/g_{k}"][d, t],
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_moe_trainer_matches_reference_at_2x2(runs):
    """Losses within rtol 2e-2, gnorm within 5e-2, failures equal; every
    rank's gnorm the same bits; the logged loss (the DP mean) the same
    bits on the two DP ranks of each TP index (the aux term is each TP
    rank's own, from the tokens it routes)."""
    jres, ranks = runs
    loss = np.stack([r["trainer/loss"] for r in ranks])
    assert loss.shape == (4, STEPS) and np.all(np.isfinite(loss))
    for r in ranks:
        assert _bits(r["trainer/gnorm"]).tobytes() == \
            _bits(ranks[0]["trainer/gnorm"]).tobytes()
    for t in range(2):
        assert _bits(loss[t]).tobytes() == _bits(loss[2 + t]).tobytes(), t
    np.testing.assert_allclose(loss[0], jres["trainer/loss"], rtol=2e-2)
    np.testing.assert_allclose(ranks[0]["trainer/gnorm"],
                               jres["trainer/gnorm"], rtol=5e-2)
    np.testing.assert_array_equal(ranks[0]["trainer/fails"],
                                  jres["trainer/fails"])


def test_moe_replicated_leaves_equal_across_tp_ranks(runs):
    """After three steps every replicated leaf (the router, wk, wv, the
    norms) holds the same params, moments and y on both TP ranks."""
    _, ranks = runs
    keys = [k for k in ranks[0] if k.startswith("repl/p/")]
    assert any(k.endswith("/router") for k in keys)
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        for k in a:
            if k.startswith("repl/"):
                assert _bits(a[k]).tobytes() == _bits(b[k]).tobytes(), (d, k)
