"""The port's MoE, Mamba-2, RG-LRU and encoder-decoder families vs the JAX
package's (CPU, one process).

The same numpy-seeded inputs go through ``repro.models`` and
``repro_torch.models`` at the smoke configs (``registry.smoke_config``):

* MoE: ``capacity`` equal; the routing (``idx``, ``pos``, ``keep``,
  ``dest``) equal exactly, ties among the router's probabilities included
  and with tokens dropped at capacity; ``moe_mlp`` at f32 within rtol 1e-5
  (its input gradients too), ``aux`` within 1e-6;
* SSM: ``ssd_chunked`` (y and the final state; a whole number of chunks
  and a padded tail), ``ssd_decode_step``, ``_dw_conv`` and
  ``mamba2_block`` (both modes) at f32 within rtol 1e-5; the port's
  chunked SSD equals its own step-by-step recurrence;
* RG-LRU: ``rg_lru`` (the scan, the scan from a state, one step from a
  state) and ``recurrent_block`` (both modes) at f32 within rtol 1e-5; the
  parallel prefix equals the port's own loop;
* encoder-decoder: metas, ``encdec_param_shapes``, ``y`` and telemetry
  shapes equal; ``init_encdec_params`` allclose, as ``init_params`` is;
* the whole loss of each family and its gradient norm at dp 1, serial and
  prefetching, within bf16 (loss rtol 2e-2, gradient norm 5e-2; the same
  for the norm of each hybrid tail layer's gradients and of the MoE
  router's, every one of those leaves' gradients nonzero; the
  compute is bf16 on both sides, and XLA's CPU backend evaluates a fused
  chain of bf16 operations in f32 where torch rounds after each).
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
from repro.models import encdec as JE
from repro.models import moe as JM
from repro.models import rglru as JG
from repro.models import sharding as JS
from repro.models import ssm as JSS
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch import random as TRnd
from repro_torch.configs import registry as TR
from repro_torch.dist.collectives import QSyncConfig as TQ
from repro_torch.models import encdec as TE
from repro_torch.models import moe as TM
from repro_torch.models import rglru as TG
from repro_torch.models import sharding as TS
from repro_torch.models import ssm as TSS
from repro_torch.models import transformer as TT

RTOL = 1e-5          # f32 blocks
LOSS_RTOL, GNORM_RTOL = 2e-2, 5e-2      # whole bf16 losses


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _ctx_pair(dp=1, bucket=64, **kw):
    return (JS.ShardCtx(dp=dp, qcfg=JQ(q=16, bucket=bucket), **kw),
            TS.ShardCtx(dp=dp, qcfg=TQ(q=16, bucket=bucket), **kw))


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _jax_routing(x, router, cfg, C):
    """The reference's routing lines (``repro.models.moe.moe_mlp``), which
    it does not return on their own."""
    T, E, K = x.shape[0], cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(x @ router, axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    e_flat = idx.reshape(-1)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    keep = pos < C
    dest = e_flat * C + jnp.minimum(pos, C - 1)
    return [np.asarray(a) for a in (idx, pos, keep, dest)]


def _moe_inputs(cfg, T, seed, ties=False):
    rng = np.random.RandomState(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff
    router = (rng.randn(D, E) / np.sqrt(D)).astype(np.float32)
    router[:, 0] += 0.5 * np.abs(router).max()        # crowd expert 0
    if ties:                                           # equal probabilities
        router[:, 3] = router[:, 1]
        router[:, 5] = router[:, 1]
    w = {"router": router,
         "w1": (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
         "w3": (rng.randn(E, D, F) / np.sqrt(D)).astype(np.float32),
         "w2": (rng.randn(E, F, D) / np.sqrt(F)).astype(np.float32)}
    x = np.abs(rng.randn(T, D)).astype(np.float32)
    return x, w


def test_moe_capacity_equal():
    for arch in ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"):
        for fn in ("config", "smoke_config"):
            jc, tc = getattr(JR, fn)(arch), getattr(TR, fn)(arch)
            for T in (1, 7, 48, 640, 2048, 4096, 8192):
                assert TM.capacity(T, tc) == JM.capacity(T, jc), (arch, T)


@pytest.mark.parametrize("ties", [False, True])
def test_moe_routing_exact(ties):
    """idx, pos, keep and dest equal the reference's exactly; tokens are
    dropped at capacity (expert 0 is crowded), and with ``ties`` three
    experts share every token's probability (the lower index first)."""
    cfg = TR.smoke_config("granite-moe-1b-a400m")
    T = 48
    C = TM.capacity(T, cfg)
    x, w = _moe_inputs(cfg, T, seed=11, ties=ties)
    want = _jax_routing(jnp.asarray(x), jnp.asarray(w["router"]), cfg, C)
    _, idx, pos, keep, dest, _ = TM.route(_t(x), _t(w["router"]), cfg, C)
    got = [a.numpy() for a in (idx, pos, keep, dest)]
    for name, g, e in zip(("idx", "pos", "keep", "dest"), got, want):
        np.testing.assert_array_equal(g, e, err_msg=name)
    assert not got[2].all(), "no token was dropped at capacity"
    if ties:
        probs = torch.softmax(_t(x) @ _t(w["router"]), -1)
        assert torch.equal(probs[:, 1], probs[:, 3])


def test_moe_mlp_f32_and_gradients():
    """moe_mlp's output and its gradients (x, the router and the experts)
    at f32 within rtol 1e-5, aux within 1e-6."""
    jcfg, tcfg = JR.smoke_config("granite-moe-1b-a400m"), \
        TR.smoke_config("granite-moe-1b-a400m")
    jctx, tctx = _ctx_pair()
    x, w = _moe_inputs(tcfg, 48, seed=5)
    ct = np.random.RandomState(6).randn(*x.shape).astype(np.float32)

    def jf(x, w):
        out, aux = JM.moe_mlp(x, w, jcfg, jctx)
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (jo, ja)), jg = jax.value_and_grad(jf, (0, 1), has_aux=True)(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()})
    xt = _t(x).requires_grad_()
    wt = {k: _t(v).requires_grad_() for k, v in w.items()}
    to, ta = TM.moe_mlp(xt, wt, tcfg, tctx)
    (torch.sum(to * _t(ct)) + ta).backward()
    _close(to.detach(), jo, atol=1e-5)
    assert abs(float(ta.detach()) - float(ja)) <= 1e-6
    _close(xt.grad, jg[0], atol=1e-5)
    for k in w:
        _close(wt[k].grad, jg[1][k], atol=1e-5)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b=2, s=40, h=3, p=8, n=16):
    rng = np.random.RandomState(seed)
    xh = (0.5 * rng.randn(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h))).astype(np.float32)
    A = (-np.exp(0.3 * rng.randn(h))).astype(np.float32)
    Bm = (0.3 * rng.randn(b, s, n)).astype(np.float32)
    Cm = (0.3 * rng.randn(b, s, n)).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("s", [32, 40])
def test_ssd_chunked_and_decode_step(s):
    """y and the final state (a whole number of chunks, and a padded
    tail), and one decode step from that state."""
    ins = _ssd_inputs(1, s=s)
    jy, jf = JSS.ssd_chunked(*map(jnp.asarray, ins), chunk=16)
    ty, tf = TSS.ssd_chunked(*map(_t, ins), chunk=16)
    _close(ty, jy)
    _close(tf, jf)
    xh, dt, A, Bm, Cm = _ssd_inputs(2, s=1)
    jy1, js1 = JSS.ssd_decode_step(jnp.asarray(xh[:, 0]),
                                   jnp.asarray(dt[:, 0]), jnp.asarray(A),
                                   jnp.asarray(Bm[:, 0]),
                                   jnp.asarray(Cm[:, 0]), jf)
    ty1, ts1 = TSS.ssd_decode_step(_t(xh[:, 0]), _t(dt[:, 0]), _t(A),
                                   _t(Bm[:, 0]), _t(Cm[:, 0]), tf)
    _close(ty1, jy1)
    _close(ts1, js1)


def test_ssd_chunked_equals_recurrence():
    """The port's chunked SSD == its own step-by-step recurrence."""
    xh, dt, A, Bm, Cm = map(_t, _ssd_inputs(3, s=24))
    y, final = TSS.ssd_chunked(xh, dt, A, Bm, Cm, chunk=8)
    state = torch.zeros(2, 3, 8, 16)
    ys = []
    for t in range(24):
        yt, state = TSS.ssd_decode_step(xh[:, t], dt[:, t], A, Bm[:, t],
                                        Cm[:, t], state)
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(final.numpy(), state.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_softplus_is_logaddexp():
    """jax.nn.softplus over the gates' range (torch's own switches to x
    above 20)."""
    x = np.linspace(-60, 60, 4001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = TSS.softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_dw_conv_both_modes():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 11, 6).astype(np.float32)
    k = rng.randn(4, 6).astype(np.float32)
    jy, _ = JSS._dw_conv(jnp.asarray(x), jnp.asarray(k))
    ty, _ = TSS._dw_conv(_t(x), _t(k))
    _close(ty, jy)
    cache = rng.randn(2, 3, 6).astype(np.float32)
    jy, jc = JSS._dw_conv(jnp.asarray(x[:, :1]), jnp.asarray(k),
                          jnp.asarray(cache))
    ty, tc = TSS._dw_conv(_t(x[:, :1]), _t(k), _t(cache))
    _close(ty, jy)
    _close(tc, jc)


def _block_weights(metas, seed, skip=()):
    """f32 weights of one layer from its metas (gates near their init)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, m in metas.items():
        if k in skip:
            continue
        shp = m.local_shape
        if m.init == "ones":
            out[k] = (1 + 0.1 * rng.randn(*shp)).astype(np.float32)
        elif m.init in ("a_log", "dt_bias"):
            out[k] = (0.5 * rng.randn(*shp)).astype(np.float32)
        else:
            out[k] = (m.init_scale * rng.randn(*shp) /
                      np.sqrt(max(shp[0], 1))).astype(np.float32)
    return out


def test_mamba2_block_both_modes():
    cfg = TR.smoke_config("mamba2-1.3b")
    jctx, tctx = _ctx_pair()
    w = _block_weights(TT._ssm_metas(cfg, tctx), 7)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 40, cfg.d_model).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: _t(v) for k, v in w.items()}
    jo, js = JSS.mamba2_block(jnp.asarray(x), jw, cfg, jctx)
    to, ts = TSS.mamba2_block(_t(x), tw, cfg, tctx)
    _close(to, jo, atol=1e-5)
    _close(ts["ssm"], js["ssm"], atol=1e-5)
    I = cfg.ssm_expand * cfg.d_model
    N, W = cfg.ssm_state, cfg.conv_width
    st = {"ssm": rng.randn(2, I // cfg.ssm_headdim, cfg.ssm_headdim,
                           N).astype(np.float32),
          "conv_x": rng.randn(2, W - 1, I).astype(np.float32),
          "conv_bc": rng.randn(2, W - 1, 2 * N).astype(np.float32)}
    jo, js = JSS.mamba2_block(jnp.asarray(x[:, :1]), jw, cfg, jctx,
                              {k: jnp.asarray(v) for k, v in st.items()})
    to, ts = TSS.mamba2_block(_t(x[:, :1]), tw, cfg, tctx,
                              {k: _t(v) for k, v in st.items()})
    _close(to, jo, atol=1e-5)
    for k in st:
        _close(ts[k], js[k], atol=1e-5)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _lru_inputs(seed, b=2, s=37, c=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, c).astype(np.float32)
    w = {"w_r": 2 * rng.randn(c), "b_r": 0.1 * rng.randn(c),
         "w_i": 2 * rng.randn(c), "b_i": 0.1 * rng.randn(c),
         "lam": rng.randn(c)}
    return x, {k: v.astype(np.float32) for k, v in w.items()}


@pytest.mark.parametrize("s", [1, 2, 37, 64])
def test_rg_lru_scan_and_step(s):
    """The scan, the scan from a state and one step from a state."""
    x, w = _lru_inputs(s, s=s)
    h0 = np.random.RandomState(9).randn(2, 8).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: _t(v) for k, v in w.items()}
    for state in (None, h0):
        jy, jh = JG.rg_lru(jnp.asarray(x), jw,
                           None if state is None else jnp.asarray(state))
        ty, th = TG.rg_lru(_t(x), tw, None if state is None else _t(state))
        _close(ty, jy)
        _close(th, jh)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 64])
def test_associative_scan_equals_loop(n):
    """The parallel prefix equals the sequential recurrence."""
    x, w = _lru_inputs(n, s=n)
    a = torch.rand(2, n, 8) * 0.9 + 0.05
    b = _t(x)
    _, hh = TG.associative_scan(TG._combine, (a, b), axis=1)
    h = torch.zeros(2, 8)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(hh[:, t].numpy(), h.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_recurrent_block_both_modes():
    cfg = TR.smoke_config("recurrentgemma-9b")
    jctx, tctx = _ctx_pair()
    w = _block_weights(TT._rec_metas(cfg, tctx, ""), 12)
    rng = np.random.RandomState(13)
    x = rng.randn(2, 21, cfg.d_model).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: _t(v) for k, v in w.items()}
    C, W = cfg.lru_width, cfg.conv_width
    st = {"lru": rng.randn(2, C).astype(np.float32),
          "conv": rng.randn(2, W - 1, C).astype(np.float32)}
    for xs, state in ((x, None), (x, {"lru": st["lru"]}), (x[:, :1], st)):
        jo, js = JG.recurrent_block(
            jnp.asarray(xs), jw, cfg, jctx,
            None if state is None else
            {k: jnp.asarray(v) for k, v in state.items()})
        to, ts = TG.recurrent_block(
            _t(xs), tw, cfg, tctx,
            None if state is None else {k: _t(v) for k, v in state.items()})
        _close(to, jo, atol=1e-5)
        _close(ts["lru"], js["lru"], atol=1e-5)
        if state is not None and xs.shape[1] == 1:
            _close(ts["conv"], js["conv"])


# ---------------------------------------------------------------------------
# Encoder-decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", [1, 4])
def test_encdec_metas_and_state_shapes(dp):
    for fn in ("config", "smoke_config"):
        jcfg, tcfg = getattr(JR, fn)("whisper-small"), \
            getattr(TR, fn)("whisper-small")
        jctx, tctx = _ctx_pair(dp=dp, bucket=4096)
        jm, tm = JE.encdec_metas(jcfg, jctx), TE.encdec_metas(tcfg, tctx)
        assert list(jm) == list(tm) == ["enc", "dec", "top"]
        for grp in jm:
            assert list(jm[grp]) == list(tm[grp]), grp
            for k, m in jm[grp].items():
                assert dataclasses.asdict(m) == \
                    dataclasses.asdict(tm[grp][k]), (grp, k)
        js = JE.encdec_param_shapes(jcfg, jctx)
        ts = TE.encdec_param_shapes(tcfg, tctx)
        jy = jax.eval_shape(lambda: JE.encdec_y_init(jcfg, jctx))
        ty = TE.encdec_y_init(tcfg, tctx, device="meta")
        jt = jax.eval_shape(lambda: JE.encdec_tele_zeros(jcfg, jctx))
        tt = TE.encdec_tele_zeros(tcfg, tctx, device="meta")
        for grp in jm:
            for k in jm[grp]:
                assert ts[grp][k] == js[grp][k].shape, (grp, k)
                assert tuple(ty[grp][k].shape) == jy[grp][k].shape
                assert tuple(tt[grp][k].shape) == jt[grp][k].shape


def test_init_encdec_params_allclose():
    """Allclose as ``init_params`` is (torch's erfinv), and a rank's slices
    are the global arrays'."""
    jcfg, tcfg = JR.smoke_config("whisper-small"), \
        TR.smoke_config("whisper-small")
    jctx, tctx = _ctx_pair(dp=4)
    jp = JE.init_encdec_params(jcfg, jctx, jax.random.PRNGKey(7))
    tp_ = TE.init_encdec_params(tcfg, tctx, TRnd.PRNGKey(7), device="cpu")
    for grp in jp:
        for k, v in jp[grp].items():
            np.testing.assert_allclose(tp_[grp][k].numpy(), np.asarray(v),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    r1 = TE.init_encdec_params(tcfg, tctx, TRnd.PRNGKey(7), dp_rank=1,
                               device="cpu")
    conv = convert.params_from_numpy(
        {g: {k: v.numpy() for k, v in t.items()} for g, t in tp_.items()},
        1, device="cpu")
    for grp in tp_:
        for k, v in tp_[grp].items():
            assert torch.equal(r1[grp][k], v[..., 1:2, :]), k
            assert torch.equal(conv[grp][k], r1[grp][k]), k


# ---------------------------------------------------------------------------
# Whole losses and their gradients, every family, dp 1
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite-moe-1b-a400m", "mamba2-1.3b", "recurrentgemma-9b",
                "whisper-small")


def _batch_np(cfg, seq=24, batch=2):
    rng = np.random.RandomState(2)
    b = {"tokens": rng.randint(0, cfg.vocab, (batch, seq)).astype(np.int32),
         "targets": rng.randint(0, cfg.vocab, (batch, seq)).astype(np.int32),
         "mask": np.ones((batch, seq), np.float32)}
    if cfg.family == "encdec":
        b["frames"] = rng.randn(batch, cfg.enc_seq,
                                cfg.d_model).astype(np.float32)
    return b


def _fns(family):
    if family == "encdec":
        return (JE.init_encdec_params, JE.make_encdec_loss_fn,
                JE.encdec_y_init, JE.encdec_tele_zeros,
                TE.make_encdec_loss_fn, TE.encdec_y_init,
                TE.encdec_tele_zeros)
    return (JT.init_params, JT.make_loss_fn, JT.y_init, JT.tele_zeros,
            TT.make_loss_fn, TT.y_init, TT.tele_zeros)


def _parts(cfg) -> dict:
    """Leaves whose share of the whole-tree norm is small, held on their
    own: (group, name) of each hybrid tail layer's leaves and of the MoE
    router."""
    if cfg.family == "hybrid":
        top = JT.top_metas(cfg, JS.ShardCtx())
        return {f"tail{t}": [("top", k) for k in sorted(top)
                             if k.startswith(f"tail{t}_")]
                for t in range(cfg.n_layers % 3)}
    if cfg.family == "moe":
        return {"router": [("layers", "router")]}
    return {}


@pytest.fixture(scope="module")
def reference_losses():
    """Each family's reference loss and gradient norm (serial; the
    reference's prefetching scan is bit-identical to it), and the norms
    of its ``_parts``, with the inputs they were computed from."""
    out = {}
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for arch in FAMILY_ARCHS:
        cfg = JR.smoke_config(arch)
        jctx, _ = _ctx_pair()
        init, make, y_init, tele_zeros = _fns(cfg.family)[:4]
        params = jax.tree.map(np.asarray,
                              init(cfg, jctx, jax.random.PRNGKey(1)))
        y = jax.tree.map(np.asarray, y_init(cfg, jctx))
        tele = jax.tree.map(np.asarray, tele_zeros(cfg, jctx))
        batch = _batch_np(cfg)
        loss_fn = make(cfg, jctx)

        @partial(jax.shard_map, mesh=mesh, in_specs=P(), out_specs=P(),
                 check_vma=False)
        def f(p, t, b, yy):
            (_, m), g = jax.value_and_grad(loss_fn, has_aux=True)(
                p, t, b, jax.random.PRNGKey(3), yy)
            sq = lambda xs: jnp.sqrt(sum(jnp.sum(x.astype(jnp.float32) ** 2)
                                         for x in xs))
            parts = {n: sq([g[grp][k] for grp, k in ls])
                     for n, ls in _parts(cfg).items()}
            return m["loss"], sq(jax.tree.leaves(g)), parts

        loss, gn, parts = jax.jit(f)(params, tele, batch, y)
        out[arch] = (float(loss), float(gn),
                     {n: float(v) for n, v in parts.items()}, params, batch)
    return out


def _leaves(tree: dict, metas: dict) -> dict:
    """Port inputs requiring grad: stacked leaves as per-layer slices."""
    out = {}
    for grp, leaves in tree.items():
        out[grp] = {}
        for k, v in leaves.items():
            t = _t(v)
            if metas[grp][k].scanned:
                out[grp][k] = [t[i].requires_grad_() for i in
                               range(t.shape[0])]
            else:
                out[grp][k] = t.requires_grad_()
    return out


def _flat(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat(v)
        elif isinstance(v, list):
            yield from v
        else:
            yield v


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one rank (the gradient sync's backward asks its
    group's size), torn down after the test so that no other test sees
    it."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_whole_loss_and_gradient_within_bf16(reference_losses, world_of_one,
                                             arch, prefetch):
    want_loss, want_gn, want_parts, params, batch = reference_losses[arch]
    cfg = TR.smoke_config(arch)
    _, tctx = _ctx_pair(prefetch=prefetch)
    make, y_init, tele_zeros = _fns(cfg.family)[4:]
    metas = (TE.encdec_metas(cfg, tctx) if cfg.family == "encdec"
             else TT.all_metas(cfg, tctx))
    p_in = _leaves(params, metas)
    t_in = _leaves({g: {k: v.numpy() for k, v in t.items()} for g, t in
                    tele_zeros(cfg, tctx, device="cpu").items()}, metas)
    loss, m = make(cfg, tctx)(p_in, t_in,
                              {k: _t(v) for k, v in batch.items()},
                              TRnd.PRNGKey(3),
                              y_init(cfg, tctx, device="cpu"))
    loss.backward()
    gn = float(torch.sqrt(sum(torch.sum(t.grad.to(torch.float32) ** 2)
                              for t in _flat(p_in))))
    assert np.isfinite(float(m["loss"])) and np.isfinite(gn) and gn > 0
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(gn, want_gn, rtol=GNORM_RTOL)
    # the tail layers and the router, each leaf's gradient nonzero
    assert set(want_parts) == set(_parts(cfg))
    for n, ls in _parts(cfg).items():
        grads = []
        for grp, k in ls:
            v = p_in[grp][k]
            grads += [t.grad for t in (v if isinstance(v, list) else [v])]
        assert all(bool(torch.any(g != 0)) for g in grads), n
        got = float(torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                                   for g in grads)))
        np.testing.assert_allclose(got, want_parts[n], rtol=GNORM_RTOL,
                                   err_msg=n)
    if cfg.family == "moe":
        assert np.isfinite(float(m["aux"])) and float(m["aux"]) > 0
