"""The port's tensor parallelism vs the JAX package's (CPU).

In one process, bitwise: the metas, storage, ``y`` and telemetry shapes of
every registry config at tp 2 and 4; the storage converters and
``init_leaf``'s rank slices at (tp, dp) = (2, 2) and (4, 2), yi-34b's
partially replicated heads (``tp_repl = 2``) included; ``reshard_anchor``
across tp changes; checkpoints crossing tp 1 -> 2 and 2 -> 1, between the
packages.

At world 2: one JAX subprocess with two emulated CPU devices runs the
reference's ``_tp_quantized_psum``, ``vp_embed`` and vocab-parallel cross
entropy inside ``shard_map`` over the ``model`` axis, and two port ranks
over a ``gloo`` group run the port's on the same numpy-seeded inputs: the
quantized psum equal bit for bit (q = 16 and 256, bucket 512, f32 and
bf16 cotangents) and common to both ranks; the embedding and the cross
entropy (value and gradients) within rtol 1e-5 at f32.  Each process has
its own time limit.
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
from repro.configs import registry as JR
from repro.dist.collectives import QSyncConfig as JQ
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JMC
from repro.train import checkpoint as JCk
from repro.train import optim as JO
from repro.train import trainer as JTr
from repro_torch import random as TRnd
from repro_torch.configs import registry as TR
from repro_torch.dist.collectives import QSyncConfig as TQ
from repro_torch.models import sharding as TS
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TMC
from repro_torch.train import checkpoint as TCk

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 240
MESHES = [(2, 2), (4, 2)]                   # (tp, dp)
DENSE = dict(arch="t", family="dense", n_layers=2, d_model=32, n_heads=8,
             n_kv=4, head_dim=8, d_ff=64, vocab=96, act="swiglu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ctx_pair(tp, dp, bucket=64, **kw):
    return (JS.ShardCtx(tp=tp, dp=dp, qcfg=JQ(q=16, bucket=bucket), **kw),
            TS.ShardCtx(tp=tp, dp=dp, qcfg=TQ(q=16, bucket=bucket), **kw))


def test_shardctx_at_tp_gt_1_builds_with_reference_fields():
    """ShardCtx(tp=2) and (tp=4) build, with the reference's TP fields and
    defaults; the port names the TP group where the reference names the
    axis."""
    for tp in (2, 4):
        j, t = JS.ShardCtx(tp=tp), TS.ShardCtx(tp=tp)
        assert t.tp == tp and t.world == j.world == tp
        for f in ("quantize_tp_grads", "seq_parallel", "remat", "prefetch",
                  "grad_sync", "gather_dtype", "anchor_grads",
                  "anchor_sharded"):
            assert getattr(t, f) == getattr(j, f), f
        assert t.tp_axis is None                  # the default group


# ---------------------------------------------------------------------------
# metas, converters, init (one process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
def test_metas_and_state_shapes_every_arch_at_tp(tp):
    for arch in JR.ARCHS:
        for fn in ("config", "smoke_config"):
            jcfg, tcfg = getattr(JR, fn)(arch), getattr(TR, fn)(arch)
            if jcfg.family == "encdec":
                continue
            jctx, tctx = _ctx_pair(tp, 2, bucket=4096)
            jm, tm = JT.all_metas(jcfg, jctx), TT.all_metas(tcfg, tctx)
            assert set(jm) == set(tm)
            L = JT.n_scan_steps(jcfg)
            for grp in jm:
                assert sorted(jm[grp]) == sorted(tm[grp]), (arch, grp)
                for k, m in jm[grp].items():
                    t = tm[grp][k]
                    assert (tuple(m.local_shape), m.tp_dim, m.scanned,
                            m.init, m.init_scale, m.tp_repl) == \
                        (tuple(t.local_shape), t.tp_dim, t.scanned, t.init,
                         t.init_scale, t.tp_repl), (arch, fn, k)
                    assert TS.storage_shape(t, tctx, L) == \
                        JS.storage_shape(m, jctx, L)
                    assert TS.logical_shape(t, tctx) == \
                        JS.logical_shape(m, jctx)
                    assert TS.anchor_shape(t, tctx, L) == \
                        JS.anchor_shape(m, jctx, L)
            ty = TT.y_init(tcfg, tctx, device="meta")
            jy = jax.eval_shape(lambda: JT.y_init(jcfg, jctx))
            tt = TT.tele_zeros(tcfg, tctx, device="meta")
            jt = jax.eval_shape(lambda: JT.tele_zeros(jcfg, jctx))
            for grp in jm:
                for k in jm[grp]:
                    assert tuple(ty[grp][k].shape) == jy[grp][k].shape
                    assert tuple(tt[grp][k].shape) == jt[grp][k].shape


def _leaves_of(arch, tp, dp):
    jcfg, tcfg = JR.smoke_config(arch), TR.smoke_config(arch)
    jctx, tctx = _ctx_pair(tp, dp)
    jm, tm = JT.all_metas(jcfg, jctx), TT.all_metas(tcfg, tctx)
    return [(f"{g}/{k}", jm[g][k], tm[g][k]) for g in jm for k in jm[g]], \
        jctx, tctx


@pytest.mark.parametrize("tp,dp", MESHES)
@pytest.mark.parametrize("arch", ["internvl2-1b", "yi-34b"])
def test_storage_converters_bitwise_at_tp(arch, tp, dp):
    leaves, jctx, tctx = _leaves_of(arch, tp, dp)
    if arch == "yi-34b" and tp == 4:
        assert dict((n, t.tp_repl) for n, _, t in leaves)["layers/wq"] == 2
    rng = np.random.RandomState(tp * 10 + dp)
    for name, jm, tm in leaves:
        shp = JS.logical_shape(jm, jctx)
        if shp[jm.tp_dim or 0] % (tp // jm.tp_repl) and not jm.tp_replicated:
            continue                # a vocab that tp does not split
        x = rng.randn(*shp).astype(np.float32)
        js = np.asarray(JS.logical_to_storage(jnp.asarray(x), jm, jctx))
        ts = TS.logical_to_storage(_t(x), tm, tctx).numpy()
        assert js.shape == ts.shape == (tp, dp, TS.shard_len(tm, tctx))
        assert js.tobytes() == ts.tobytes(), name
        back = TS.storage_to_logical(_t(ts), tm, tctx).numpy()
        assert back.tobytes() == x.tobytes(), name
        assert np.asarray(JS.storage_to_logical(jnp.asarray(js), jm, jctx)
                          ).tobytes() == back.tobytes(), name


@pytest.mark.parametrize("tp,dp", MESHES)
@pytest.mark.parametrize("arch", ["internvl2-1b", "yi-34b"])
def test_init_leaf_at_tp(arch, tp, dp):
    """The global storage allclose to the reference's (its normal draws go
    through torch's erfinv, about 6e-6 relative); ones and zeros bitwise;
    every (tp, dp) rank slice, drawn alone, bitwise the global array's;
    and the threefry bits under each TP row bitwise jax.random's."""
    leaves, jctx, tctx = _leaves_of(arch, tp, dp)
    key = 11
    for name, jm, tm in leaves:
        L = 2
        jg = np.asarray(JS.init_leaf(jax.random.PRNGKey(key), jm, jctx, L))
        tg = TS.init_leaf(TRnd.PRNGKey(key), tm, tctx, L, device="cpu")
        assert tuple(tg.shape) == jg.shape, name
        if tm.init in ("ones", "zeros"):
            assert tg.numpy().tobytes() == jg.tobytes(), name
        else:
            np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        for t in range(tp):
            for d in range(dp):
                r = TS.init_leaf(TRnd.PRNGKey(key), tm, tctx, L, dp_rank=d,
                                 tp_rank=t, device="cpu")
                assert torch.equal(r, tg[..., t:t + 1, d:d + 1, :]), \
                    (name, t, d)
    rows, n = 2, 4096
    k = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.bits(k, (rows, n), jnp.uint32))
    for r in range(rows):
        got = TRnd.bits(TRnd.PRNGKey(5), (rows, n), device="cpu",
                        span=(r * n + 100, r * n + 900)).numpy()
        assert got.astype(np.uint32).tobytes() == \
            want[r, 100:900].tobytes()


@pytest.mark.parametrize("target", [(2, 2, 8), (4, 2, 8), (1, 4, 4),
                                    (3, 2, 2, 8), (3, 4, 2, 8), (3, 1, 2, 8),
                                    (2, 4, 8), (7,)])
def test_reshard_anchor_across_tp_bitwise(target):
    """Replicated anchors migrate into (L?, tp, dp, shard) at any tp; an
    anchor already in storage layout for another tp passes through (the
    trainer then keeps its fresh y), as in the reference."""
    rng = np.random.RandomState(len(target))
    sources = [rng.randn(16).astype(np.float32),
               rng.randn(3, 16).astype(np.float32),
               rng.randn(1, 2, 8).astype(np.float32),
               rng.randn(3, 2, 2, 8).astype(np.float32)]
    for a in sources:
        j = JCk.reshard_anchor(a, target)
        t = TCk.reshard_anchor(a, target)
        assert np.shape(j) == np.shape(t)
        assert np.asarray(j).tobytes() == np.asarray(t).tobytes()
    tree = {"layers": {"wq": {"y": np.ones(3, np.float32),
                              "anchor": sources[1]}}}
    tgt = {"layers": {"wq": {"y": np.ones(3, np.float32),
                             "anchor": np.zeros((3, 4, 2, 8), np.float32)}}}
    jo, to = JCk.reshard_y(tree, tgt), TCk.reshard_y(tree, tgt)
    assert jo["layers"]["wq"]["anchor"].tobytes() == \
        to["layers"]["wq"]["anchor"].tobytes()


def _dense_state(ctx, key):
    cfg = JMC(**DENSE)
    return cfg, JTr.init_state(cfg, ctx, JO.OptConfig(),
                               JTr.TrainConfig(), jax.random.PRNGKey(key))


@pytest.mark.parametrize("src_tp,dst_tp", [(1, 2), (2, 1), (2, 4)])
def test_checkpoint_across_tp_and_packages(tmp_path, src_tp, dst_tp):
    """The reference writes a checkpoint at tp = src_tp; the port reads it
    at tp = dst_tp, every (tp, dp) rank's slice bitwise the reference's
    own restore; the port's params_to_logical of the reference's storage
    writes a checkpoint the reference reads back bitwise."""
    dp = 2
    jsrc = JS.ShardCtx(tp=src_tp, dp=dp, qcfg=JQ(q=16, bucket=64))
    cfg, state = _dense_state(jsrc, 3)
    metas_src = JT.all_metas(cfg, jsrc)
    logical = JCk.params_to_logical(state["params"], metas_src, jsrc)
    JCk.save(str(tmp_path / "jax"), 4, {"params": logical}, {"arch": "t"})
    tree, meta = TCk.load(str(tmp_path / "jax"))
    assert meta["step"] == 4
    jdst = JS.ShardCtx(tp=dst_tp, dp=dp, qcfg=JQ(q=16, bucket=64))
    tdst = TS.ShardCtx(tp=dst_tp, dp=dp, qcfg=TQ(q=16, bucket=64))
    tcfg = TMC(**DENSE)
    jm, tm = JT.all_metas(cfg, jdst), TT.all_metas(tcfg, tdst)
    want = JCk.logical_to_params(tree["params"], jm, jdst)
    for t in range(dst_tp):
        for d in range(dp):
            got = TCk.logical_to_params(tree["params"], tm, tdst, d,
                                        "cpu", t)
            for g in want:
                for k, v in want[g].items():
                    w = np.asarray(v)[..., t:t + 1, d:d + 1, :]
                    assert got[g][k].numpy().tobytes() == w.tobytes(), \
                        (g, k, t, d)
    # the port writes the logical tensors of the reference's storage
    tsrc = TS.ShardCtx(tp=src_tp, dp=dp, qcfg=TQ(q=16, bucket=64))
    tlog = TCk.params_to_logical(
        {g: {k: _t(np.asarray(v)) for k, v in state["params"][g].items()}
         for g in state["params"]}, TT.all_metas(tcfg, tsrc), tsrc)
    TCk.save(str(tmp_path / "port"), 5, {"params": tlog}, {"arch": "t"})
    back, _ = JCk.load(str(tmp_path / "port"))
    for g in logical:
        for k, v in logical[g].items():
            assert back["params"][g][k].tobytes() == \
                np.asarray(v).tobytes(), (g, k)


# ---------------------------------------------------------------------------
# world 2: the quantized TP psum, the embedding, the cross entropy
# ---------------------------------------------------------------------------

N_PSUM = (896, 3000)            # a norm's length (bucket shrinks to 512), 2+
V, D, T_, B, S = 97, 16, 40, 2, 6


def _psum_inputs(rng):
    """Per-rank gradients: (tp, n) for each length, in f32 and bf16."""
    return {n: (rng.randn(2, n) * 1e-2).astype(np.float32) for n in N_PSUM}


def _write_inputs(path):
    rng = np.random.RandomState(0)
    flat = {f"g{n}": v for n, v in _psum_inputs(rng).items()}
    flat["emb"] = (0.3 * rng.randn(2 * (-(-V // 2)), D)).astype(np.float32)
    flat["tokens"] = rng.randint(0, V, (B, S)).astype(np.int32)
    flat["x"] = rng.randn(T_, D).astype(np.float32)
    flat["targets"] = rng.randint(0, V, T_).astype(np.int32)
    flat["targets"][:3] = [V - 1, 0, V // 2]
    flat["mask"] = (rng.rand(T_) > 0.2).astype(np.float32)
    np.savez(path, **flat)


_JAX_SCRIPT = """
import sys
from functools import partial
import numpy as np
import repro  # noqa: F401
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist.collectives import QSyncConfig
from repro.models import layers as LY, sharding as S, transformer as T

inp, out = sys.argv[1:3]
z = dict(np.load(inp))
mesh = jax.make_mesh((2,), ("model",),
                     axis_types=(jax.sharding.AxisType.Auto,))
res = {}
for q in (16, 256):
    ctx = S.ShardCtx(tp=2, dp=1, qcfg=QSyncConfig(q=q, bucket=512))
    for n in (896, 3000):
        for dt in ("float32", "bfloat16"):
            g = jnp.asarray(z[f"g{n}"]).astype(dt)
            f = jax.jit(jax.shard_map(
                lambda a: S._tp_quantized_psum(a[0], ctx)[None], mesh=mesh,
                in_specs=P("model"), out_specs=P("model"), check_vma=False))
            res[f"psum/{q}/{n}/{dt}"] = np.asarray(
                f(g).astype(jnp.float32))
ctx = S.ShardCtx(tp=2, dp=1)
emb = jnp.asarray(z["emb"])
v_loc = emb.shape[0] // 2

@partial(jax.shard_map, mesh=mesh, in_specs=(P("model"), P()),
         out_specs=P("model"), check_vma=False)
def embed(e, tok):
    return LY.vp_embed(tok, e, ctx)[None]

res["embed"] = np.asarray(jax.jit(embed)(emb, jnp.asarray(z["tokens"])))
tg, mk = jnp.asarray(z["targets"]), jnp.asarray(z["mask"])

@partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("model")),
         out_specs=(P("model"), P("model"), P("model")), check_vma=False)
def ce(x, h):
    def loss(x, h):
        s, c = T._ce_sum(x, h, tg, ctx, mk)
        return s / c / ctx.tp
    l, (gx, gh) = jax.value_and_grad(loss, (0, 1))(x, h)
    return (l * ctx.tp)[None], gx[None], gh
l, gx, gh = jax.jit(ce)(jnp.asarray(z["x"]), emb)
res["ce/loss"], res["ce/gx"], res["ce/gh"] = map(np.asarray, (l, gx, gh))
np.savez(out, **res)
"""

_RANK_SCRIPT = """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.models import layers as LY, sharding as S

rank, port, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
z = dict(np.load(inp))
res = {}
for q in (16, 256):
    ctx = S.ShardCtx(tp=2, dp=1, qcfg=QSyncConfig(q=q, bucket=512))
    for n in (896, 3000):
        for dt in ("float32", "bfloat16"):
            g = torch.from_numpy(z[f"g{n}"][rank].copy()).to(getattr(torch, dt))
            res[f"psum/{q}/{n}/{dt}"] = S._tp_quantized_psum(g, ctx).to(
                torch.float32).numpy()
ctx = S.ShardCtx(tp=2, dp=1)
emb = torch.from_numpy(z["emb"])
v_loc = emb.shape[0] // 2
own = emb[rank * v_loc:(rank + 1) * v_loc].clone()
res["embed"] = LY.vp_embed(torch.from_numpy(z["tokens"]), own, ctx).numpy()
LY.CE_ROWS = 16
x = torch.from_numpy(z["x"]).requires_grad_()
h = own.clone().requires_grad_()
s, c = LY.ce_sum(x, h, torch.from_numpy(z["targets"]), ctx,
                 torch.from_numpy(z["mask"]))
(s / c / ctx.tp).backward()
res["ce/loss"] = (s / c).detach().numpy()
res["ce/gx"], res["ce/gh"] = x.grad.numpy(), h.grad.numpy()
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
def world2(tmp_path_factory):
    import socket

    tmp = tmp_path_factory.mktemp("tp2")
    inp = tmp / "inputs.npz"
    _write_inputs(inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")

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
    procs = [start("jax reference", _JAX_SCRIPT, inp, tmp / "jax.npz")]
    procs += [start(f"port rank {r}", _RANK_SCRIPT, r, port, inp,
                    tmp / f"rank{r}.npz") for r in range(2)]
    _finish(procs, time.monotonic() + LIMIT_S)
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)])


@pytest.mark.parametrize("q", [16, 256])
@pytest.mark.parametrize("n", N_PSUM)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quantized_tp_psum_bitwise(world2, q, n, dt):
    """Bit for bit the reference's, and the same on both TP ranks (the
    butterfly's common output): replicated leaves stay equal."""
    jres, ranks = world2
    k = f"psum/{q}/{n}/{dt}"
    want = jres[k]                                    # (2, n)
    for r, res in enumerate(ranks):
        assert res[k].tobytes() == want[r].tobytes(), (k, r)
    assert ranks[0][k].tobytes() == ranks[1][k].tobytes()


def test_vp_embed_allclose(world2):
    jres, ranks = world2
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["embed"], jres["embed"][r], rtol=1e-5,
                                   atol=0)


def test_vocab_parallel_cross_entropy_allclose(world2):
    """The loss (the same on both ranks), the gradient of x and of each
    rank's vocab rows (the padded row included) at f32, rtol 1e-5."""
    jres, ranks = world2
    v_loc = -(-V // 2)
    assert ranks[0]["ce/loss"].tobytes() == ranks[1]["ce/loss"].tobytes()
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["ce/loss"], jres["ce/loss"][r],
                                   rtol=1e-5)
        np.testing.assert_allclose(res["ce/gx"], jres["ce/gx"][r], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(
            res["ce/gh"], jres["ce/gh"][r * v_loc:(r + 1) * v_loc],
            rtol=1e-5, atol=1e-7)
