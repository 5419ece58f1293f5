"""The cell builders (``repro_torch.launch.steps``) against the JAX
package's (``repro.launch.steps``).

* Structs: for all 10 archs x 4 shapes on the 16 x 16 and 2 x 16 x 16
  production layouts and at ``smoke=True`` on (2, 2) (the decode cells
  with and without ``kv_quant``), the port's global argument structs have
  the reference's tree (keys and leaf order), shapes and dtypes; the
  reference's are built on a device-less ``AbstractMesh``, the port's in
  a fake group of the layout's world (``launch/mesh.fake_world``).  A cell
  the reference refuses the port refuses too.  The fake group and the
  production layouts are checked on their own: the groups ``mesh_axes``
  builds for (2, 16, 16) have the layout's sizes.
* One JAX subprocess with four emulated devices runs the reference's
  encoder-decoder train step (``_make_encdec_train_step``, the quantized
  gradient sync) for whisper-smoke on a (2, 2) and a (2, 1) mesh from one
  seeded state and batch; four port ranks over ``gloo`` run the port's on
  the same layouts (ranks 0 and 1 join a second group for (2, 1)).  Held:
  the loss within rtol 2e-2 and the gnorm within 5e-2 (the bf16 chains'
  bounds of ``tests/test_torch_tp_train.py``), every rank's loss and gnorm
  the same bits, and the update: the reference's jitted
  ``optim.apply_update`` on rank 0's gradients, state and gnorm gives
  the port's new parameters and f32 moments bit for bit.
* Local structs: on every rank of the (2, 2) group the local structs of
  the internvl2-smoke and whisper-smoke train cells have the shapes and
  dtypes of the state and batch the rank allocates (``trainer.init_state``
  and the data pipeline; whisper's state from the reference's).
"""
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro  # noqa: F401  (jax compatibility shims)
from repro.configs import registry as JRg
from repro.configs import shapes as JSH
from repro.launch import steps as JST
from repro.models import encdec as JE
from repro.train import optim as JO

from repro_torch.configs import registry
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import (fake_world, layout, make_production_mesh,
                                     mesh_axes)

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 300
LAYOUTS = (((16, 16), False), ((2, 16, 16), False), ((2, 2), True))
ENCDEC = "whisper-small"
MESHES = ((2, 2), (2, 1))


def _cells():
    for shape, spec in JSH.SHAPES.items():
        for kvq in ((False, True) if spec.kind in ("decode", "long_decode")
                    else (None,)):
            yield shape, kvq


def _kw(smoke, kvq):
    kw = {"smoke": smoke}
    if kvq is not None:
        kw["kv_quant"] = kvq
    return kw


def _ref_flat(arch, shape, shp, smoke, kvq):
    mesh = AbstractMesh(shp, layout(shp).axis_names)
    try:
        _, args, _, _ = JST.build_cell(arch, shape, mesh,
                                       **_kw(smoke, kvq))
    except ValueError:
        return None
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(args)[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        out.append((key, tuple(leaf.shape), np.dtype(leaf.dtype).name))
    return out


def _port_flat(arch, shape, shp, smoke, kvq):
    kw = _kw(smoke, kvq)
    if JSH.SHAPES[shape].kind == "train":
        kw["device"] = "cpu"
    try:
        _, args, _, _ = ST.build_cell(arch, shape, shp, **kw)
    except ValueError:
        return None
    out = []

    def walk(t, key):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], key + (k,))
        elif isinstance(t, (tuple, list)):
            for i, v in enumerate(t):
                walk(v, key + (i,))
        else:
            assert t.is_meta
            out.append((key, tuple(t.shape),
                        str(t.dtype).replace("torch.", "")))
    walk(args, ())
    return out


@pytest.mark.parametrize("arch", list(JRg.ARCHS))
def test_structs_match_reference(arch):
    assert list(registry.ARCHS) == list(JRg.ARCHS)
    for shp, smoke in LAYOUTS:
        with fake_world(int(np.prod(shp))):
            for shape, kvq in _cells():
                want = _ref_flat(arch, shape, shp, smoke, kvq)
                got = _port_flat(arch, shape, shp, smoke, kvq)
                assert got == want, (arch, shape, shp, kvq)


def test_production_layouts_and_the_fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa
    import torch.distributed as dist

    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.axis_names) == ((16, 16), ("data", "model"))
    assert (two.shape, two.axis_names) == ((2, 16, 16),
                                           ("pod", "data", "model"))
    with fake_world(512, rank=37):
        assert dist.get_world_size() == 512 and dist.get_rank() == 37
        dp_axes, tp_axis = mesh_axes(two.shape)
        assert [dist.get_world_size(g) for g in dp_axes] == [2, 16]
        assert dist.get_world_size(tp_axis) == 16
        assert dist.get_rank(tp_axis) == 37 % 16
        assert dist.get_rank(dp_axes[1]) == (37 // 16) % 16
    assert not dist.is_initialized()


def test_local_shape_splits_each_named_dim():
    t = ST._meta((3, 16, 32, 40), torch.float32,
                 (None, "model", ("pod", "data"), None))
    assert ST.local_shape(t, (2, 16, 16)) == (3, 1, 1, 40)
    t2 = ST._meta((3, 16, 32, 40), torch.float32, (None, "model", "data"))
    assert ST.local_shape(t2, (16, 16)) == (3, 1, 2, 40)
    with pytest.raises(ValueError):
        ST.local_shape(ST._meta((5,), torch.float32, ("data",)), (2, 2))


# ---------------------------------------------------------------------------
# the encoder-decoder step and the local structs, across processes
# ---------------------------------------------------------------------------

def _flat(tree, prefix):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _inputs(path):
    cfg = JRg.smoke_config(ENCDEC)
    flat = {}
    for shp in MESHES:
        mesh = AbstractMesh(shp, ("data", "model"))
        ctx = JST.make_ctx(cfg, mesh)
        params = JE.init_encdec_params(cfg, ctx, jax.random.PRNGKey(0))
        opt = JO.init_opt_state(params, JO.OptConfig())
        y = JE.encdec_y_init(cfg, ctx)
        tag = "x".join(map(str, shp))
        flat.update(_flat({"params": params, "opt": opt, "y": y},
                          f"{tag}/state"))
    rng = np.random.RandomState(0)
    B, S = 8, 64
    flat["batch/tokens"] = rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    flat["batch/targets"] = rng.randint(0, cfg.vocab, (B, S)).astype(
        np.int32)
    flat["batch/mask"] = (rng.rand(B, S) < 0.9).astype(np.float32)
    flat["batch/frames"] = rng.randn(B, cfg.enc_seq,
                                     cfg.d_model).astype(np.float32)
    np.savez(path, **flat)


_UNFLAT = """
def unflat(z, prefix):
    tree = {}
    for k, v in z.items():
        if k.startswith(prefix + "/"):
            parts = k[len(prefix) + 1:].split("/")
            cur = tree
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = v
    return tree
"""

_JAX_SCRIPT = _UNFLAT + """
import sys
import numpy as np
import repro  # noqa: F401
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.launch import steps as ST

inp, out = sys.argv[1:3]
z = dict(np.load(inp))
res = {}
batch = {k: z[f"batch/{k}"] for k in ("tokens", "targets", "mask", "frames")}
for shp in ((2, 2), (2, 1)):
    tag = "x".join(map(str, shp))
    mesh = Mesh(np.array(jax.devices()[:shp[0] * shp[1]]).reshape(shp),
                ("data", "model"))
    step, _, cfg, ctx = ST.train_cell("whisper-small", "train_4k", mesh,
                                      smoke=True)
    st = unflat(z, f"{tag}/state")
    st["step"] = jnp.int32(0)
    st["key"] = jax.random.PRNGKey(0)
    _, m = step(st, batch)
    res[f"{tag}/loss"] = np.asarray(m["loss"])
    res[f"{tag}/gnorm"] = np.asarray(m["gnorm"])
np.savez(out, **res)
"""

_RANK_SCRIPT = _UNFLAT + """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch import random as R
from repro_torch.launch import steps as ST
from repro_torch.train import data as D
from repro_torch.train import optim as O
from repro_torch.train import trainer as TR

rank, port1, port2, inp, out = sys.argv[1:6]
rank = int(rank)
torch.set_num_threads(1)
z = dict(np.load(inp))
res = {}
captured = {}
apply_update = O.apply_update


def capture(params, grads, opt, step, cfg, gnorm):
    p2, o2 = apply_update(params, grads, opt, step, cfg, gnorm)
    captured.update(params=params, grads=grads, opt=opt, step=step,
                    gnorm=gnorm, new_params=p2, new_opt=o2)
    return p2, o2


O.apply_update = capture


def flat(tree, prefix):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().numpy()
    return out


def shapes_match(structs, actual):
    ok = True
    if isinstance(structs, dict):
        ok = sorted(structs) == sorted(actual)
        return ok and all(shapes_match(structs[k], actual[k])
                          for k in structs)
    if isinstance(structs, torch.Tensor):
        return (isinstance(actual, torch.Tensor)
                and tuple(actual.shape) == tuple(structs.shape)
                and actual.dtype == structs.dtype)
    return type(structs) is type(actual)


def encdec(shp, dp_idx, tp_idx):
    tag = "x".join(map(str, shp))
    step, (st_s, b_s), cfg, ctx = ST.train_cell(
        "whisper-small", "train_4k", shp, smoke=True, device="cpu")
    state = convert.train_state_from_numpy(
        unflat(z, f"{tag}/state") | {"step": np.int32(0),
                                     "key": np.zeros(2, np.uint32)},
        cfg, ctx, dp_idx, device="cpu", tp_rank=tp_idx)
    state["key"] = R.PRNGKey(0)
    bl = 8 // ctx.dp
    batch = {k: torch.from_numpy(
        z[f"batch/{k}"][dp_idx * bl:(dp_idx + 1) * bl].copy())
        for k in ("tokens", "targets", "mask", "frames")}
    loc_state, loc_batch = ST.local_structs((st_s, b_s), shp)
    res[f"{tag}/whisper_local_ok"] = np.asarray(
        shapes_match(loc_state, state) and shapes_match(loc_batch, batch))
    captured.clear()
    _, m = step(state, batch)
    res[f"{tag}/loss"] = m["loss"].numpy()
    res[f"{tag}/gnorm"] = m["gnorm"].numpy()
    if rank == 0:
        for k in ("params", "grads", "new_params"):
            res.update(flat(captured[k], f"{tag}/upd/{k}"))
        for k in ("opt", "new_opt"):
            res.update(flat(captured[k], f"{tag}/upd/{k}"))
        res[f"{tag}/upd/step"] = np.asarray(captured["step"])
        res[f"{tag}/upd/gnorm"] = captured["gnorm"].numpy()


def join(port, world):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))


join(port1, 4)
dp_idx, tp_idx = rank // 2, rank % 2
encdec((2, 2), dp_idx, tp_idx)

# internvl2-smoke: the local structs against what the rank allocates
step, (st_s, b_s), cfg, ctx = ST.train_cell(
    "internvl2-1b", "train_4k", (2, 2), smoke=True, device="cpu")
state = TR.init_state(cfg, ctx, O.OptConfig(), TR.TrainConfig(),
                      R.PRNGKey(0), device="cpu")
data = D.DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
batch = D.local_batch_at(data, 0, dp_idx, ctx.dp, device="cpu")
batch["img"] = D.frames_at(data, 0, cfg.img_tokens, cfg.d_model,
                           rows=(dp_idx * 4, dp_idx * 4 + 4), device="cpu")
loc_state, loc_batch = ST.local_structs((st_s, b_s), (2, 2))
res["internvl2_local_ok"] = np.asarray(
    shapes_match(loc_state, state) and shapes_match(loc_batch, batch))
dist.destroy_process_group()

if rank < 2:
    join(port2, 2)
    encdec((2, 1), rank, 0)
    dist.destroy_process_group()
np.savez(out, **res)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steps")
    inp = tmp / "inputs.npz"
    _inputs(inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")

    def start(name, script, *args):
        log = tmp / f"{name.replace(' ', '_')}.log"
        with open(log, "w") as f:
            p = subprocess.Popen([sys.executable, "-c", script,
                                  *map(str, args)], env=env, stdout=f,
                                 stderr=subprocess.STDOUT)
        return name, p, log

    p1, p2 = _free_port(), _free_port()
    procs = [start("jax reference", _JAX_SCRIPT, inp, tmp / "jax.npz")]
    procs += [start(f"port rank {r}", _RANK_SCRIPT, r, p1, p2, inp,
                    tmp / f"rank{r}.npz") for r in range(4)]
    deadline = time.monotonic() + LIMIT_S
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
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("shp", MESHES)
def test_encdec_step_matches_reference(runs, shp):
    ref, ranks = runs
    tag = "x".join(map(str, shp))
    ranks = ranks[:shp[0] * shp[1]]
    for f, rtol in (("loss", 2e-2), ("gnorm", 5e-2)):
        bits = {np.asarray(r[f"{tag}/{f}"], np.float32).tobytes()
                for r in ranks}
        assert len(bits) == 1, (f, [r[f"{tag}/{f}"] for r in ranks])
        np.testing.assert_allclose(ranks[0][f"{tag}/{f}"],
                                   ref[f"{tag}/{f}"], rtol=rtol)


@pytest.mark.parametrize("shp", MESHES)
def test_encdec_update_bitwise_with_f32_moments(runs, shp):
    _, ranks = runs
    r0 = ranks[0]
    tag = "x".join(map(str, shp))
    pre = f"{tag}/upd/"

    def tree(name):
        out = {}
        for k, v in r0.items():
            if k.startswith(pre + name + "/"):
                parts = k[len(pre + name) + 1:].split("/")
                cur = out
                for p in parts[:-1]:
                    cur = cur.setdefault(p, {})
                cur[parts[-1]] = v
        return out

    opt = tree("opt")
    assert all(v.dtype == np.float32 for g in opt["m"].values()
               for v in g.values())
    cfg = JO.OptConfig()
    fn = jax.jit(lambda P, G, S, s, n: JO.apply_update(P, G, S, s, cfg, n))
    jp, jo = fn(tree("params"), tree("grads"), opt,
                int(r0[pre + "step"]), r0[pre + "gnorm"])

    def same(a, b):
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(
                    np.asarray(a[k]).view(np.uint32),
                    np.asarray(b[k]).view(np.uint32), err_msg=k)
    same(tree("new_params"), jax.tree.map(np.asarray, jp))
    same(tree("new_opt"), jax.tree.map(np.asarray, jo))


def test_local_structs_match_what_each_rank_allocates(runs):
    _, ranks = runs
    for r, res in enumerate(ranks):
        assert bool(res["internvl2_local_ok"]), r
        assert bool(res["2x2/whisper_local_ok"]), r
    for r in range(2):
        assert bool(ranks[r]["2x1/whisper_local_ok"]), r
