"""The Mamba-2 and RG-LRU hybrid families on a TP mesh: the port vs the JAX
package (CPU).

One JAX subprocess with four emulated CPU devices runs, on a (2, 2) mesh
(``data``, ``model``), for mamba2-smoke and recurrentgemma-smoke:

* the scanned unit at f32 (``transformer.ssm_block``; ``hybrid_unit``: two
  RG-LRU layers, then the local-attention layer with its window of 16 at
  24 tokens and its one KV head replicated over TP), with sequence
  parallelism and without: the output and, under a seeded cotangent of
  each rank's own, the gradients of the input and of every weight;
* the reference ``Trainer`` for three steps with sequence parallelism and
  the f32 gradient sync (the TP psum of the replicated leaves' gradients
  in f32; the quantized syncs around the same forward and backward are
  ``tests/test_torch_tp_train.py``'s and ``test_torch_moe_tp.py``'s, and
  would take this file's reference three times as long to compile);
  recurrentgemma-smoke's two unscanned tail layers run there too;
* on a (1, 2) mesh of two of the devices, whisper-smoke's loss and
  gradient norm (the training step's: the replicated leaves counted
  once), with the f32 sync and no sequence parallelism, as the
  reference's launcher sets them for the encoder-decoder.

Four port ranks over a ``gloo`` group (``launch/mesh.mesh_axes((2, 2))``)
run the same.  Held: the units within rtol 1e-5 at f32 on every rank (and
1e-5 of each array's largest entry; what
runs only under TP: the gated RMSNorm's TP psum of its sum of squares,
the TP-replicated ``wbc``/``conv_bc`` and KV head, the SP gather and
scatter around each mixer, the window under SP); the trainers' losses
within rtol 2e-2 and gnorm within 5e-2 (``tests/test_torch_tp_train.py``'s
tolerances), every rank's loss and
gnorm the same bits, and every replicated leaf (params, moments, y) the
same bits on the two TP ranks of a DP group; whisper's loss within
rtol 2e-2 and its gradient norm within 5e-2 on every rank (each TP pair
of the four ranks is a (1, 2) mesh), the replicated leaves' gradients the
same bits on both ranks of a pair.
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
from repro.models import encdec as JE
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro.train import checkpoint as JCk
from repro.train import data as JD
from repro.train import optim as JO
from repro.train import trainer as JTr

ROOT = Path(__file__).resolve().parents[1]
STEPS, SEQ, LIMIT_S = 3, 24, 300
ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
B_UNIT = 2                       # sequences per DP rank in the unit check
ENCDEC = "whisper-small"


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _unit_weights(metas, rng):
    """Each leaf's two TP ranks' f32 weights, stacked (2, *local shape):
    one draw for both where the leaf is TP-replicated."""
    out = {}
    for k, m in sorted(metas.items()):
        shp = m.local_shape

        def draw():
            if m.init == "ones":
                return 1 + 0.1 * rng.randn(*shp)
            if m.init in ("a_log", "dt_bias"):
                return 0.5 * rng.randn(*shp)
            return m.init_scale * rng.randn(*shp) / np.sqrt(max(shp[0], 1))
        if m.tp_replicated:
            w = draw()
            out[k] = np.stack([w, w])
        else:
            out[k] = np.stack([draw(), draw()])
        out[k] = out[k].astype(np.float32)
    return out


def _reference_inputs(path):
    ctx = JS.ShardCtx(tp=2, dp=2, grad_sync="fp32", seq_parallel=True)
    rng = np.random.RandomState(0)
    flat = {}
    for arch in ARCHS:
        cfg = JRg.smoke_config(arch)
        state = JTr.init_state(cfg, ctx, JO.OptConfig(), JTr.TrainConfig(),
                               jax.random.PRNGKey(0))
        for top in ("params", "opt", "y"):
            leaves = JCk._flatten(jax.tree.map(np.asarray, state[top]))
            for k, v in leaves.items():
                flat[f"{arch}/{top}/{k}"] = v
        flat[f"{arch}/step"] = np.asarray(state["step"])
        flat[f"{arch}/key"] = np.asarray(state["key"])
        for k, v in _unit_weights(JT.block_metas(cfg, ctx), rng).items():
            flat[f"{arch}/w/{k}"] = v
        D = cfg.d_model
        flat[f"{arch}/x"] = rng.randn(2, B_UNIT, SEQ, D).astype(np.float32)
        for sp, s_loc in ((False, SEQ), (True, SEQ // 2)):
            flat[f"{arch}/ct/{sp}"] = rng.randn(2, 2, B_UNIT, s_loc,
                                                D).astype(np.float32)
    cfg = JRg.smoke_config(ENCDEC)
    ctx = JS.ShardCtx(tp=2, dp=1, grad_sync="fp32")
    params = JE.init_encdec_params(cfg, ctx, jax.random.PRNGKey(4))
    for k, v in JCk._flatten(jax.tree.map(np.asarray, params)).items():
        flat[f"{ENCDEC}/params/{k}"] = v
    flat[f"{ENCDEC}/frames"] = rng.randn(2, cfg.enc_seq,
                                         cfg.d_model).astype(np.float32)
    for k in ("tokens", "targets"):
        flat[f"{ENCDEC}/{k}"] = rng.randint(0, cfg.vocab,
                                            (2, SEQ)).astype(np.int32)
    data = JD.DataConfig(vocab=JRg.smoke_config(ARCHS[0]).vocab,
                         seq_len=SEQ, global_batch=2)
    assert all(JRg.smoke_config(a).vocab == data.vocab for a in ARCHS)
    for s in range(STEPS):
        for k, v in JD.batch_at(data, s).items():
            flat[f"batch{s}/{k}"] = v
    np.savez(path, **flat)


_JAX_SCRIPT = """
import sys
from functools import partial
import numpy as np
import repro  # noqa: F401
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import registry
from repro.models import transformer as T
from repro.models.sharding import ShardCtx
from repro.train import data as D
from repro.train.optim import OptConfig
from repro.train.trainer import Trainer, TrainConfig

inp, out, ckpt, steps, seq = sys.argv[1:6]
steps, seq = int(steps), int(seq)
z = dict(np.load(inp))
res = {}
DM = P("data", "model")
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)

for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
    cfg = registry.smoke_config(arch)
    for sp in (False, True):
        ctx = ShardCtx(tp=2, dp=2, seq_parallel=sp)
        names = sorted(T.block_metas(cfg, ctx))
        xspec = P("data", None, "model") if sp else P("data")

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(xspec, {k: P("model") for k in names}, DM),
                 out_specs=(DM, DM, {k: DM for k in names}),
                 check_vma=False)
        def unit(x, w, ct):
            pos = jnp.arange(seq, dtype=jnp.int32)

            def f(x, w):
                if cfg.family == "ssm":
                    return T.ssm_block(x, w, cfg, ctx)
                return T.hybrid_unit(x, w, cfg, ctx, pos)
            o, vjp = jax.vjp(f, x[0], {k: v[0] for k, v in w.items()})
            gx, gw = vjp(ct[0, 0])
            return (o[None, None], gx[None, None],
                    {k: v[None, None] for k, v in gw.items()})
        o, gx, gw = jax.jit(unit)(z[f"{arch}/x"],
                                  {k: z[f"{arch}/w/{k}"] for k in names},
                                  z[f"{arch}/ct/{sp}"])
        tag = f"unit/{arch}/{sp}"
        res[f"{tag}/out"], res[f"{tag}/gx"] = np.asarray(o), np.asarray(gx)
        for k, v in gw.items():
            res[f"{tag}/g_{k}"] = np.asarray(v)

    data = D.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)
    ctx = ShardCtx(tp=2, dp=2, grad_sync="fp32", seq_parallel=True)
    tr = Trainer(cfg, ctx, mesh, OptConfig(lr=1e-2, warmup=2, decay_steps=10),
                 TrainConfig(steps=steps, ckpt_dir=f"{ckpt}/{arch}",
                             ckpt_every=1000, log_every=1), data)
    tr.train()
    for f in ("loss", "gnorm"):
        res[f"trainer/{arch}/{f}"] = np.asarray([h[f] for h in tr.history])

# whisper-smoke at (1, 2): the loss and the training step's gradient norm
from repro.models import encdec as ED
from repro.models.sharding import storage_spec
cfg = registry.smoke_config("whisper-small")
ctx = ShardCtx(tp=2, dp=1, grad_sync="fp32")
metas = ED.encdec_metas(cfg, ctx)
mesh12 = jax.make_mesh((1, 2), ("data", "model"), devices=jax.devices()[:2],
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
pspec = {g: {k: storage_spec(m, ctx) for k, m in metas[g].items()}
         for g in metas}
params = {g: {k: z[f"whisper-small/params/{g}/{k}"] for k in metas[g]}
          for g in metas}
batch = {"frames": z["whisper-small/frames"],
         "tokens": z["whisper-small/tokens"],
         "targets": z["whisper-small/targets"],
         "mask": np.ones(z["whisper-small/tokens"].shape, np.float32)}
loss_fn = ED.make_encdec_loss_fn(cfg, ctx)


@partial(jax.shard_map, mesh=mesh12, in_specs=(pspec, P()),
         out_specs=(P(), P()), check_vma=False)
def encdec_step(p, b):
    (_, m), g = jax.value_and_grad(loss_fn, has_aux=True)(
        p, ED.encdec_tele_zeros(cfg, ctx), b, jax.random.PRNGKey(5),
        ED.encdec_y_init(cfg, ctx))
    sq = jnp.zeros((), jnp.float32)
    for grp in g:
        for name, gg in g[grp].items():
            t = jnp.sum(gg.astype(jnp.float32) ** 2)
            if not metas[grp][name].tp_replicated:
                t = jax.lax.psum(t, "model")
            sq = sq + t
    return m["loss"], jnp.sqrt(sq)


loss, gn = jax.jit(encdec_step)(params, batch)
res["encdec/loss"], res["encdec/gnorm"] = np.asarray(loss), np.asarray(gn)
np.savez(out, **res)
"""

_RANK_SCRIPT = """
import datetime, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.train import data as D
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import Trainer, TrainConfig

rank, port, inp, out, tmp, steps, seq = sys.argv[1:8]
rank, steps, seq = int(rank), int(steps), int(seq)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
dp_axes, tp_axis = mesh_axes((2, 2))
dp12, tp12 = mesh_axes((2, 1, 2))       # each TP pair a (1, 2) mesh
dp_idx, tp_idx = rank // 2, rank % 2
z = dict(np.load(inp))
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
res = {}


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


for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
    cfg = registry.smoke_config(arch)
    for sp in (False, True):
        ctx = S.ShardCtx(tp=2, dp=2, dp_axes=dp_axes, tp_axis=tp_axis,
                         seq_parallel=sp)
        x = z[f"{arch}/x"][dp_idx]
        if sp:
            h = seq // 2
            x = x[:, tp_idx * h:(tp_idx + 1) * h]
        xt = t(x).requires_grad_()
        w = {k: t(z[f"{arch}/w/{k}"][tp_idx]).requires_grad_()
             for k in T.block_metas(cfg, ctx)}
        if cfg.family == "ssm":
            o = T.ssm_block(xt, w, cfg, ctx)
        else:
            o = T.hybrid_unit(xt, w, cfg, ctx,
                              torch.arange(seq, dtype=torch.int32))
        torch.sum(o * t(z[f"{arch}/ct/{sp}"][dp_idx, tp_idx])).backward()
        tag = f"unit/{arch}/{sp}"
        res[f"{tag}/out"], res[f"{tag}/gx"] = o.detach().numpy(), \\
            xt.grad.numpy()
        for k, v in w.items():
            res[f"{tag}/g_{k}"] = v.grad.numpy()

    state_np = {"params": unflat(f"{arch}/params"),
                "opt": unflat(f"{arch}/opt"), "y": unflat(f"{arch}/y"),
                "step": z[f"{arch}/step"], "key": z[f"{arch}/key"]}
    ctx = S.ShardCtx(tp=2, dp=2, dp_axes=dp_axes, tp_axis=tp_axis,
                     grad_sync="fp32", seq_parallel=True)
    data = D.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)
    tr = Trainer(cfg, ctx, OptConfig(lr=1e-2, warmup=2, decay_steps=10),
                 TrainConfig(steps=steps,
                             ckpt_dir=os.path.join(tmp, f"ckpt_{arch}"),
                             ckpt_every=1000, log_every=1), data,
                 device="cpu")
    tr._batch = lambda step: {
        k: torch.from_numpy(z[f"batch{step}/{k}"][dp_idx:dp_idx + 1].copy())
        for k in ("tokens", "targets", "mask")}
    st = tr.train(convert.train_state_from_numpy(
        state_np, cfg, ctx, dp_idx, device="cpu", tp_rank=tp_idx))
    for f in ("loss", "gnorm"):
        res[f"trainer/{arch}/{f}"] = np.asarray([h[f] for h in tr.history])
    for g in ("layers", "top"):
        for k, m in tr.metas[g].items():
            if m.tp_replicated:
                res[f"repl/{arch}/p/{g}/{k}"] = st["params"][g][k].numpy()
                res[f"repl/{arch}/y/{g}/{k}"] = st["y"][g][k].numpy()
                for mk, mv in st["opt"].items():
                    res[f"repl/{arch}/{mk}/{g}/{k}"] = mv[g][k].numpy()

# whisper-smoke at (1, 2): the f32 sync, no SP
from repro_torch import random as R
from repro_torch.models import encdec as ED
cfg = registry.smoke_config("whisper-small")
ctx = S.ShardCtx(tp=2, dp=1, dp_axes=dp12[1:], tp_axis=tp12,
                 grad_sync="fp32")
metas = ED.encdec_metas(cfg, ctx)
p_np = convert.params_from_numpy(unflat("whisper-small/params"), 0,
                                 device="cpu", tp_rank=tp_idx)


def leaves(tree):
    return {g: {k: ([v[i].clone().requires_grad_()
                     for i in range(v.shape[0])] if metas[g][k].scanned
                    else v.clone().requires_grad_()) for k, v in t.items()}
            for g, t in tree.items()}


p_in = leaves(p_np)
t_in = leaves(ED.encdec_tele_zeros(cfg, ctx, device="cpu"))
batch = {k: t(z[f"whisper-small/{k}"]) for k in ("frames", "tokens",
                                                  "targets")}
batch["mask"] = torch.ones(batch["tokens"].shape)
loss, m = ED.make_encdec_loss_fn(cfg, ctx)(
    p_in, t_in, batch, R.PRNGKey(5), ED.encdec_y_init(cfg, ctx, device="cpu"))
loss.backward()
sq = {True: 0.0, False: 0.0}
repl = []
for g in metas:
    for k, meta in metas[g].items():
        v = p_in[g][k]
        for x in (v if isinstance(v, list) else [v]):
            sq[meta.tp_replicated] += float(torch.sum(x.grad.double() ** 2))
            if meta.tp_replicated:
                repl.append(x.grad.reshape(-1))
res["encdec/loss"] = np.asarray(float(m["loss"]))
res["encdec/sq_repl"], res["encdec/sq_shard"] = sq[True], sq[False]
res["encdec/repl_grads"] = torch.cat(repl).numpy()
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

    tmp = tmp_path_factory.mktemp("families_tp")
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
                   tmp / "jax_ckpt", STEPS, SEQ)]
    procs += [start(f"port rank {r}", _RANK_SCRIPT, r, port, inp,
                    tmp / f"rank{r}.npz", tmp, STEPS, SEQ)
              for r in range(4)]
    _finish(procs, time.monotonic() + LIMIT_S)
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_unit_on_the_mesh_f32(runs, arch, sp):
    """Every rank's output and gradients (input, every weight) within
    rtol 1e-5 and 1e-5 of the array's largest entry, at f32 (the two
    packages sum the gradients in other orders)."""
    jres, ranks = runs
    tag = f"unit/{arch}/{sp}"
    names = [k[len(tag) + 3:] for k in jres if k.startswith(f"{tag}/g_")]
    assert "ln1" in names or "r1_ln1" in names
    for r, res in enumerate(ranks):
        d, t = r // 2, r % 2
        for name in ["out", "gx"] + [f"g_{k}" for k in names]:
            want = jres[f"{tag}/{name}"][d, t]
            got = res[f"{tag}/{name}"]
            assert got.shape == want.shape, (r, name, got.shape, want.shape)
            np.testing.assert_allclose(
                got, want, rtol=1e-5, atol=1e-5 * np.max(np.abs(want)),
                err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference_at_2x2(runs, arch):
    """Losses within rtol 2e-2, gnorm within 5e-2; every rank's loss
    (TP-global, then the DP mean) and gnorm the same bits."""
    jres, ranks = runs
    loss = np.stack([r[f"trainer/{arch}/loss"] for r in ranks])
    assert loss.shape == (4, STEPS) and np.all(np.isfinite(loss))
    for r in ranks:
        for f in ("loss", "gnorm"):
            assert _bits(r[f"trainer/{arch}/{f}"]).tobytes() == \
                _bits(ranks[0][f"trainer/{arch}/{f}"]).tobytes(), f
    np.testing.assert_allclose(loss[0], jres[f"trainer/{arch}/loss"],
                               rtol=2e-2)
    np.testing.assert_allclose(ranks[0][f"trainer/{arch}/gnorm"],
                               jres[f"trainer/{arch}/gnorm"], rtol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_leaves_equal_across_tp_ranks(runs, arch):
    """After three steps every replicated leaf (the norms, mamba2's
    ``wbc``/``conv_bc``, recurrentgemma's KV head and its tail layers'
    norms) holds the same params, moments and y on both TP ranks."""
    _, ranks = runs
    pre = f"repl/{arch}/"
    keys = [k for k in ranks[0] if k.startswith(pre + "p/")]
    want = ("/wbc",) if arch.startswith("mamba2") else ("/at_wk", "/tail0_ln1")
    for w in want:
        assert any(k.endswith(w) for k in keys), w
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        for k in a:
            if k.startswith(pre):
                assert _bits(a[k]).tobytes() == _bits(b[k]).tobytes(), (d, k)


def test_encdec_at_tp2_matches_reference(runs):
    """whisper-smoke at (dp 1, tp 2), the f32 sync, no SP: the loss within
    rtol 2e-2 and the gradient norm (the replicated leaves counted once)
    within 5e-2 on both ranks of each TP pair; the replicated leaves'
    gradients (TP-psummed) the same bits on both ranks of a pair."""
    jres, ranks = runs
    for pair in ((0, 1), (2, 3)):
        a, b = (ranks[r] for r in pair)
        assert _bits(a["encdec/repl_grads"]).tobytes() == \
            _bits(b["encdec/repl_grads"]).tobytes(), pair
        gn = np.sqrt(a["encdec/sq_shard"] + b["encdec/sq_shard"]
                     + a["encdec/sq_repl"])
        assert np.isfinite(gn) and gn > 0
        np.testing.assert_allclose(gn, jres["encdec/gnorm"], rtol=5e-2)
        for r in (a, b):
            np.testing.assert_allclose(float(r["encdec/loss"]),
                                       float(jres["encdec/loss"]), rtol=2e-2)
