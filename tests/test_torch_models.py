"""The port's models and configs vs the JAX package's (CPU, one process).

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models``:

* the layers at f32 (rms_norm, rope, GQA attention unchunked and
  query-chunked, the three MLP activations, the cross entropy) agree to
  rtol 1e-5;
* every arch in the registry has the same metas, storage, ``y`` and
  telemetry shapes at dp 1, 4 and 8 (the encoder-decoder family raises in
  both); every family but the encoder-decoder builds a loss function;
* the storage converters are bitwise, ``init_params`` allclose (its
  normal draws go through torch's ``erfinv``);
* the whole loss of internvl2-smoke and glm4-9b-smoke, given the same
  storage arrays, agrees within bf16 tolerance (the compute is bf16).
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro  # noqa: F401  (jax compatibility shims)
from repro.configs import registry as JR
from repro.dist.collectives import QSyncConfig as JQ
from repro.models import layers as JL
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro_torch.configs import registry as TR
from repro_torch.dist.collectives import QSyncConfig as TQ
from repro_torch.models import layers as TL
from repro_torch.models import sharding as TS
from repro_torch.models import transformer as TT
from repro_torch import random as TRnd


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ctx_pair(dp=1, bucket=64, **kw):
    return (JS.ShardCtx(dp=dp, qcfg=JQ(q=16, bucket=bucket), **kw),
            TS.ShardCtx(dp=dp, qcfg=TQ(q=16, bucket=bucket), **kw))


def test_registry_configs_equal_reference():
    assert TR.ARCHS == JR.ARCHS
    for arch in JR.ARCHS:
        for fn in ("config", "smoke_config"):
            assert dataclasses.asdict(getattr(TR, fn)(arch)) == \
                dataclasses.asdict(getattr(JR, fn)(arch)), (arch, fn)
        assert TR.train_overrides(arch) == JR.train_overrides(arch)
        assert TR.config(arch).param_count() == JR.config(arch).param_count()


def test_rms_norm_and_rope():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 4, 16).astype(np.float32)
    sc = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x), _t(sc)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(sc))), rtol=1e-5,
        atol=1e-6)
    pos = np.arange(9, dtype=np.int32)
    cj, sj = JL.rope_angles(jnp.asarray(pos), 16, 1e6)
    ct, st = TL.rope_angles(_t(pos), 16, 1e6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        TL.apply_rope(_t(x), ct, st).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), cj, sj)), rtol=1e-5,
        atol=1e-5)


@pytest.mark.parametrize("S", [40, 600])
def test_attention_gqa(S):
    """GQA attention at f32, unchunked (S <= 512) and query-chunked."""
    cfg = TR.smoke_config("internvl2-1b")          # 4 heads over 2 KV heads
    jctx, tctx = _ctx_pair()
    rng = np.random.RandomState(S)
    D, hd = cfg.d_model, cfg.head_dim
    w = {"wq": rng.randn(D, cfg.n_heads * hd), "wk": rng.randn(D, cfg.n_kv * hd),
         "wv": rng.randn(D, cfg.n_kv * hd), "wo": rng.randn(cfg.n_heads * hd, D)}
    w = {k: (v / np.sqrt(D)).astype(np.float32) for k, v in w.items()}
    x = rng.randn(1, S, D).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want = np.asarray(JL.attention(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}, cfg, jctx,
        positions=jnp.asarray(pos)))
    got = TL.attention(_t(x), {k: _t(v) for k, v in w.items()}, cfg, tctx,
                       positions=_t(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_head_maps_equal_reference():
    for arch in ("internvl2-1b", "glm4-9b", "qwen3-32b", "yi-34b"):
        jcfg, tcfg = JR.config(arch), TR.config(arch)
        jctx, tctx = _ctx_pair()
        assert TL.local_heads(tcfg, tctx) == JL.local_heads(jcfg, jctx)
        assert TL.head_repl(tcfg, tctx) == JL.head_repl(jcfg, jctx)
        np.testing.assert_array_equal(
            TL._kv_map_local(tcfg, tctx).numpy(),
            np.asarray(JL._kv_map_local(jcfg, jctx)))


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_mlp_activations(act):
    cfg = dataclasses.replace(TR.smoke_config("glm4-9b"), act=act)
    rng = np.random.RandomState(3)
    D, Fd = cfg.d_model, cfg.d_ff
    names = ("wg", "wu", "wd") if act == "swiglu" else ("wi", "wd")
    w = {k: (rng.randn(*((Fd, D) if k == "wd" else (D, Fd))) / np.sqrt(D))
         .astype(np.float32) for k in names}
    x = rng.randn(2, 7, D).astype(np.float32)
    want = np.asarray(JL.mlp(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in w.items()}, cfg))
    got = TL.mlp(_t(x), {k: _t(v) for k, v in w.items()}, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cross_entropy_and_its_gradient(monkeypatch):
    """CE sum at f32 over several row blocks, and its gradient."""
    monkeypatch.setattr(TL, "CE_ROWS", 16)
    jctx, tctx = _ctx_pair()
    rng = np.random.RandomState(5)
    T_, D, V = 50, 32, 97
    x = rng.randn(T_, D).astype(np.float32)
    head = (0.3 * rng.randn(V, D)).astype(np.float32)
    tg = rng.randint(0, V, T_).astype(np.int32)
    mask = (rng.rand(T_) > 0.2).astype(np.float32)

    def jloss(x, h):
        s, c = JT._ce_sum(x, h, jnp.asarray(tg), jctx, jnp.asarray(mask))
        return s / c
    (jl, (jgx, jgh)) = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(x),
                                                         jnp.asarray(head))
    xt, ht = _t(x).requires_grad_(), _t(head).requires_grad_()
    s, c = TL.ce_sum(xt, ht, _t(tg), tctx, _t(mask))
    (s / c).backward()
    np.testing.assert_allclose(float((s / c).detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("dp", [1, 4, 8])
def test_metas_and_state_shapes_every_arch(dp):
    for arch in JR.ARCHS:
        for cfg_fn in ("config", "smoke_config"):
            jcfg = getattr(JR, cfg_fn)(arch)
            tcfg = getattr(TR, cfg_fn)(arch)
            jctx, tctx = _ctx_pair(dp=dp, bucket=4096)
            if jcfg.family == "encdec":
                for f, c, x in ((JT.all_metas, jcfg, jctx),
                                (TT.all_metas, tcfg, tctx)):
                    with pytest.raises(ValueError):
                        f(c, x)
                continue
            jm, tm = JT.all_metas(jcfg, jctx), TT.all_metas(tcfg, tctx)
            assert list(jm) == list(tm)
            for grp in jm:
                assert list(jm[grp]) == list(tm[grp]), (arch, grp)
                for k, m in jm[grp].items():
                    assert dataclasses.asdict(m) == \
                        dataclasses.asdict(tm[grp][k]), (arch, k)
                    t = tm[grp][k]
                    assert TS.shard_len(t, tctx) == JS.shard_len(m, jctx)
                    assert TS.leaf_nb(t, tctx) == JS.leaf_nb(m, jctx)
                    assert TS.leaf_tele_width(t, tctx) == \
                        JS.leaf_tele_width(m, jctx)
                    L = JT.n_scan_steps(jcfg)
                    assert TS.storage_shape(t, tctx, L) == \
                        JS.storage_shape(m, jctx, L)
            jy = jax.eval_shape(lambda: JT.y_init(jcfg, jctx))
            ty = TT.y_init(tcfg, tctx, device="meta")
            jt = jax.eval_shape(lambda: JT.tele_zeros(jcfg, jctx))
            tt = TT.tele_zeros(tcfg, tctx, device="meta")
            for grp in jm:
                for k in jm[grp]:
                    assert tuple(ty[grp][k].shape) == jy[grp][k].shape
                    assert tuple(tt[grp][k].shape) == jt[grp][k].shape


def test_forward_of_other_families_raises():
    """Every family but the encoder-decoder builds a loss function in both
    packages; the encoder-decoder's ``make_loss_fn`` raises ``ValueError``
    in both (its loss is ``models/encdec.py``'s).  ``ShardCtx(tp=2)``
    builds, with the reference's fields and defaults."""
    jctx, tctx = _ctx_pair()
    for arch in JR.ARCHS:
        jcfg, tcfg = JR.smoke_config(arch), TR.smoke_config(arch)
        if jcfg.family == "encdec":
            for f, c, x in ((JT.make_loss_fn, jcfg, jctx),
                            (TT.make_loss_fn, tcfg, tctx)):
                with pytest.raises(ValueError):
                    f(c, x)
            continue
        assert tcfg.family in TT.FORWARD_FAMILIES
        assert callable(JT.make_loss_fn(jcfg, jctx))
        assert callable(TT.make_loss_fn(tcfg, tctx))
    t, j = TS.ShardCtx(tp=2), JS.ShardCtx(tp=2)
    assert (t.tp, t.dp, t.world) == (j.tp, j.dp, j.world) == (2, 1, 2)
    for f in ("quantize_tp_grads", "seq_parallel", "grad_sync", "remat",
              "gather_dtype", "anchor_grads", "anchor_sharded", "prefetch"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("dp", [1, 4])
def test_storage_converters_bitwise(dp):
    jctx, tctx = _ctx_pair(dp=dp)
    rng = np.random.RandomState(dp)
    for shape in ((64, 48), (7,), (33, 5)):
        jm = JS.LeafMeta(shape, tp_dim=None)
        tm = TS.LeafMeta(shape, tp_dim=None)
        x = rng.randn(*shape).astype(np.float32)
        js = np.asarray(JS.logical_to_storage(jnp.asarray(x), jm, jctx))
        ts = TS.logical_to_storage(_t(x), tm, tctx).numpy()
        assert js.tobytes() == ts.tobytes()
        back = TS.storage_to_logical(_t(ts), tm, tctx).numpy()
        assert back.tobytes() == x.tobytes()
        assert np.asarray(JS.storage_to_logical(jnp.asarray(js), jm, jctx)
                          ).tobytes() == back.tobytes()


@pytest.mark.parametrize("arch", ["internvl2-1b", "glm4-9b"])
def test_init_params_allclose_and_rank_slices(arch):
    """Allclose as ``random.normal`` is (torch's erfinv: about 6e-6
    relative, tests/test_torch_dme.py::test_normal_allclose)."""
    jcfg, tcfg = JR.smoke_config(arch), TR.smoke_config(arch)
    jctx, tctx = _ctx_pair(dp=4)
    jp = JT.init_params(jcfg, jctx, jax.random.PRNGKey(7))
    tp_ = TT.init_params(tcfg, tctx, TRnd.PRNGKey(7), device="cpu")
    for grp in jp:
        for k, v in jp[grp].items():
            np.testing.assert_allclose(tp_[grp][k].numpy(), np.asarray(v),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    # a rank draws only its slice: the same numbers as the global array's
    r2 = TT.init_params(tcfg, tctx, TRnd.PRNGKey(7), dp_rank=2, device="cpu")
    for grp in tp_:
        for k, v in tp_[grp].items():
            assert torch.equal(r2[grp][k], v[..., 2:3, :]), k


def _loss_pair(arch, dp_seq=24, batch=2):
    """The reference's and the port's loss on the same storage arrays and
    batch, at dp = 1."""
    jcfg, tcfg = JR.smoke_config(arch), TR.smoke_config(arch)
    jctx, tctx = _ctx_pair()
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jctx, jax.random.PRNGKey(1)))
    rng = np.random.RandomState(2)
    batch_np = {"tokens": rng.randint(0, jcfg.vocab, (batch, dp_seq))
                .astype(np.int32),
                "targets": rng.randint(0, jcfg.vocab, (batch, dp_seq))
                .astype(np.int32),
                "mask": np.ones((batch, dp_seq), np.float32)}
    if jcfg.family == "vlm":
        batch_np["img"] = rng.randn(batch, jcfg.img_tokens,
                                    jcfg.d_model).astype(np.float32)
    y = jax.tree.map(np.asarray, JT.y_init(jcfg, jctx))
    tele = jax.tree.map(np.asarray, JT.tele_zeros(jcfg, jctx))
    mesh = jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    jloss = JT.make_loss_fn(jcfg, jctx)

    @partial(jax.shard_map, mesh=mesh, in_specs=P(), out_specs=P(),
             check_vma=False)
    def f(p, t, b, yy):
        return jloss(p, t, b, jax.random.PRNGKey(3), yy)[0]

    want = float(jax.jit(f)(params, tele, batch_np, y))
    tloss = TT.make_loss_fn(tcfg, tctx)
    tree = lambda t: {g: {k: _t(v) for k, v in t[g].items()} for g in t}
    got, metrics = tloss(tree(params), tree(tele),
                         {k: _t(v) for k, v in batch_np.items()},
                         TRnd.PRNGKey(3), tree(y))
    return float(got), want


@pytest.mark.parametrize("arch", ["internvl2-1b", "glm4-9b"])
def test_whole_loss_within_bf16(arch):
    got, want = _loss_pair(arch)
    assert np.isfinite(got)
    # bf16 activations and weights on both sides, summed in other orders
    np.testing.assert_allclose(got, want, rtol=2e-2)
