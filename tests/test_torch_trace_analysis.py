"""The op recorder and its analyses (``repro_torch.launch.trace_analysis``),
the torch counterpart of ``tests/test_hlo_analysis.py`` and
``tests/test_hlo_overlap.py``: their cases rebuilt as torch programs on
``meta`` tensors, traced by the recorder.

* FLOPs: a loop of L matmuls counts exactly 2 n^3 L, a nested 3 x 5 loop
  2 * 64^3 * 15 (an eager loop is unrolled in the trace, so the count is
  the trip-expanded one by construction); ``einsum`` and ``matmul``, which
  reach the recorder whole under ``torch.inference_mode``, count as their
  products; the traffic proxy counts an elementwise op's inputs and
  output, a fill's output, and no view.
* The overlap audit over ``LAYER_SPAN`` bodies in a fake group of four:
  a gather whose result feeds the next matmul is exposed (1.0); one whose
  result is used only after another matmul is overlapped (0.0); an async
  issue and its wait count once, eager (``async_op=True``) and functional
  (``wait_tensor``), and a matmul issued between them overlaps it.
* The kernels' shape-only implementations on ``meta`` tensors: the
  kernel's output shapes and dtypes, one recorded kernel op each,
  counted in ``FAKE_LAUNCHES`` and not in ``LAUNCHES`` or the dispatch
  counts.
* A whole smoke train cell: the prefetching layer loop audits strictly
  below the serial one.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels import _build
from repro_torch.kernels import ops as K
from repro_torch.launch import dryrun as DR
from repro_torch.launch import trace_analysis as TA
from repro_torch.launch.mesh import fake_world
from repro_torch.models.transformer import LAYER_SPAN

META = torch.device("meta")


def _trace(fn):
    with TA.Recorder() as rec:
        fn()
    return rec.log


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.mark.parametrize("L", [1, 4, 12])
def test_loop_of_matmuls_counts_every_trip(L):
    n = 128
    x, w = _m(n, n), _m(n, n)

    def prog():
        y = x
        for _ in range(L):
            y = y @ w
    c = TA.analyze(_trace(prog))
    assert c.dot_flops == 2 * n ** 3 * L


def test_nested_loops_multiply():
    n = 64
    x, w = _m(n, n), _m(n, n)

    def prog():
        y = x
        for _ in range(3):
            for _ in range(5):
                y = y @ w
    assert TA.analyze(_trace(prog)).dot_flops == 2 * 64 ** 3 * 15


def test_composite_products_count_under_inference_mode():
    a, b = _m(2, 8, 16), _m(2, 16, 4)
    q, k = _m(2, 5, 3, 8), _m(2, 7, 3, 8)

    @torch.inference_mode()
    def prog():
        torch.matmul(a, b)
        torch.einsum("bqhd,bkhd->bhqk", q, k)
    c = TA.analyze(_trace(prog))
    assert c.dot_flops == 2 * 2 * 8 * 4 * 16 + 2 * (2 * 5 * 3 * 8 * 7)


def test_einsum_flops_pairwise():
    # (bhp, bn) -> bhpn, then (bhpn, bh) -> bhpn: 2 * b*h*p*n twice
    assert TA.einsum_flops("bhp,bn,bh->bhpn",
                           [(2, 3, 4), (2, 5), (2, 3)]) == 2 * 2 * (
        2 * 3 * 4 * 5)


def test_traffic_counts_ops_fills_and_no_views():
    x, y = _m(1000), _m(1000)

    def prog():
        z = x + y                    # 3 x 4000 bytes
        z.view(10, 100)              # a view: nothing
        torch.zeros(1000, device=META)  # a fill: its output
    assert TA.analyze(_trace(prog)).traffic == 3 * 4000 + 4000


def _gather(x, async_op=False):
    out = torch.empty((4 * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = dist.all_gather_into_tensor(out, x, async_op=async_op)
    return out, work


@pytest.fixture
def world4():
    with fake_world(4):
        yield


def test_serial_gather_then_matmul_is_exposed(world4):
    x, w = _m(16, 16), _m(16, 16)

    def prog():
        for _ in range(3):
            with torch.profiler.record_function(LAYER_SPAN):
                full, _ = _gather(x)
                full[:16] @ w
    a = TA.audit_overlap(_trace(prog))
    assert len(a.bodies) == 3
    assert a.total_bytes == 3 * 4 * 16 * 16 * 4
    assert a.exposed_fraction == 1.0


def test_gather_used_after_another_matmul_is_overlapped(world4):
    x, w = _m(16, 16), _m(16, 16)

    def prog():
        with torch.profiler.record_function(LAYER_SPAN):
            full, work = _gather(x, async_op=True)
            x @ w                     # compute while the gather flies
            work.wait()
            full[:16] @ w
    a = TA.audit_overlap(_trace(prog))
    assert a.total_bytes > 0 and a.exposed_fraction == 0.0


def test_blocking_gather_is_exposed_whatever_follows(world4):
    """A blocking call waits before it returns: a matmul issued after it
    overlaps nothing."""
    x, w = _m(16, 16), _m(16, 16)

    def prog():
        with torch.profiler.record_function(LAYER_SPAN):
            full, _ = _gather(x)
            x @ w
            full[:16] @ w
    assert TA.audit_overlap(_trace(prog)).exposed_fraction == 1.0


def test_async_issue_and_wait_count_once(world4):
    x, w = _m(16, 16), _m(16, 16)

    def eager(between: bool):
        def prog():
            with torch.profiler.record_function(LAYER_SPAN):
                out = torch.empty((64, 16), device=META)
                work = dist.all_gather_into_tensor(out, x, async_op=True)
                if between:
                    x @ w
                work.wait()
                out[:16] @ w
        return prog

    for between, frac in ((False, 1.0), (True, 0.0)):
        log = _trace(eager(between))
        c = TA.analyze(log)
        assert c.coll["all-gather_count"] == 1
        assert c.coll["all-gather"] == 64 * 16 * 4
        a = TA.audit_overlap(log)
        assert len(a.bodies[0]["collectives"]) == 1
        assert a.exposed_fraction == frac


def test_functional_issue_and_wait_count_once(world4):
    from torch.distributed import _functional_collectives as FC

    x, w = _m(16, 16), _m(16, 16)
    group = dist.group.WORLD

    def prog(between):
        with torch.profiler.record_function(LAYER_SPAN):
            out = FC.all_gather_tensor(x, 0, group)
            if between:
                x @ w
            FC.wait_tensor(out)[:16] @ w

    for between, frac in ((False, 1.0), (True, 0.0)):
        log = _trace(lambda: prog(between))
        assert [e["op"] for e in log if e["cls"] == "wait"]
        c = TA.analyze(log)
        assert c.coll["all-gather_count"] == 1
        assert c.coll["all-gather"] == 64 * 16 * 4
        assert TA.audit_overlap(log).exposed_fraction == frac


def test_send_and_receive_are_one_ppermute(world4):
    from repro_torch.dist import collectives as C

    x = _m(1024)
    log = _trace(lambda: C._ppermute(x, [(i, (i + 1) % 4)
                                         for i in range(4)]))
    c = TA.analyze(log)
    assert c.coll == {"ppermute": 4096.0, "ppermute_count": 1}


def test_kernels_answer_meta_tensors_with_shapes():
    _build.reset_launch_counts()
    K.reset_dispatch_counts()
    n, q, bucket = 4096, 16, 1024
    x, u = _m(n), _m(n)
    sides = _m(n // bucket)

    def prog():
        words, coords = K.lattice_encode(x, u, sides, q=q,
                                         return_coords=True, bucket=bucket)
        assert words.shape == (n * 4 // 32,) and words.dtype == torch.int32
        assert coords.shape == (n,) and coords.dtype == torch.int32
        z = K.lattice_decode(words, x, u, sides, q=q, bucket=bucket)
        assert z.shape == (n,) and z.dtype == torch.float32
        k = K.lattice_decode(words, x, u, sides, q=q, mode="coords",
                             bucket=bucket)
        assert k.dtype == torch.int32
        kb = K.lattice_decode_batched(_m(3, n // 8, dtype=torch.int32), x,
                                      u, sides, q=q, bucket=bucket)
        assert kb.shape == (3, n) and kb.dtype == torch.int32
        h = K.fwht(_m(6, 256, dtype=torch.bfloat16))
        assert h.shape == (6, 256) and h.dtype == torch.bfloat16
        o = K.flash_attention(_m(4, 32, 64), _m(4, 48, 64), _m(4, 48, 64))
        assert o.shape == (4, 32, 64)

    log = _trace(prog)
    assert TA.kernel_calls(log) == {"lattice_encode": 1, "lattice_decode": 2,
                                    "lattice_decode_batched": 1, "fwht": 1,
                                    "flash_attention": 1}
    assert _build.FAKE_LAUNCHES == TA.kernel_calls(log)
    assert not any(_build.LAUNCHES.values())
    assert not any(K.DISPATCH_COUNTS.values())
    att = next(e for e in log if e.get("kernel") == "flash_attention")
    assert att["flops"] == 4 * 4 * 32 * 48 * 64


def test_smoke_cell_prefetch_audits_below_serial():
    """The reference's ``bench_nn.fsdp_overlap`` claim on a whole train
    step: internvl2-smoke on (2, 2), every forward layer's FSDP gathers
    issued a layer ahead against the serial loop."""
    frac = {p: DR.run_cell("internvl2-1b", "train_4k", mesh=(2, 2),
                           smoke=True, prefetch=p)
            ["collective_exposed_fraction"] for p in (False, True)}
    assert frac[False] == 1.0
    assert 0.0 < frac[True] < frac[False]
