"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.agg.client import AggClient
from repro_torch.agg.server import AggServer
from repro_torch.agg.transport import frame as wire
from repro_torch.core import lattice as TL
from repro_torch.dist.collectives import QSyncConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TRef

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


# every kind of color space: 1 bit (q = 1, 2), powers of two, and q not a
# power of two at 2, 4, 8 and 16 bits
CARD_QS = (1, 2, 3, 4, 12, 16, 256, 1000, 65535, 65536)


def _inputs(n, bucket, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 2).astype(np.float32)
    u = (rng.rand(n) - 0.5).astype(np.float32)
    a = (x + 0.3 * rng.randn(n)).astype(np.float32)
    sides = (0.05 + 0.2 * rng.rand(-(-n // bucket))).astype(np.float32)
    return x, u, a, sides


@pytest.mark.parametrize("q", CARD_QS)
@pytest.mark.parametrize("kind", ["scalar", "coord", "bucket"])
def test_encode_matches_plain(cuda, q, kind):
    n, bucket = 5003, 256
    x, u, a, sides = _inputs(n, bucket, q)
    s, b = {"scalar": (float(sides[0]), None),
            "coord": (_t(np.repeat(sides, bucket)[:n]), None),
            "bucket": (_t(sides), bucket)}[kind]
    s_d = s.to(cuda) if isinstance(s, torch.Tensor) else s
    for anchor in (None, _t(a)):
        want_w, want_k = TRef.lattice_encode_ref(
            _t(x), _t(u), s, q=q, bits=TL.bits_for_q(q), return_coords=True,
            anchor=anchor, bucket=b)
        before = _build.LAUNCHES["lattice_encode"]
        w, k = TK.lattice_encode(
            _t(x, cuda), _t(u, cuda), s_d, q=q, return_coords=True,
            anchor=None if anchor is None else anchor.to(cuda), bucket=b)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["lattice_encode"] == before + 1
        np.testing.assert_array_equal(k.cpu().numpy(), want_k.numpy())
        np.testing.assert_array_equal(w.cpu().numpy(), want_w.numpy())


@pytest.mark.parametrize("q", CARD_QS)
@pytest.mark.parametrize("mode", ["coords", "point"])
def test_decode_batched_matches_plain(cuda, q, mode):
    S, n, bucket = 7, 5003, 256
    rng = np.random.RandomState(q)
    _, u, a, sides = _inputs(n, bucket, q + 1)
    sides_s = (np.tile(sides, (S, 1))
               * (1 + 0.1 * rng.rand(S, 1))).astype(np.float32)
    words = rng.randint(0, 1 << 32, (S, TL.packed_len(n, TL.bits_for_q(q))),
                        dtype=np.uint64).astype(np.uint32).view(np.int32)
    ref = _t((0.25 * a).astype(np.float32))
    for s, b in ((_t(sides_s), bucket), (float(sides_s[0, 0]), None),
                 (_t(np.repeat(sides_s, bucket, axis=1)[:, :n]), None)):
        want = TRef.lattice_decode_batched_ref(
            _t(words), _t(a), _t(u), s, q=q, bits=TL.bits_for_q(q), n=n,
            mode=mode, ref=ref, bucket=b)
        before = _build.LAUNCHES["lattice_decode_batched"]
        got = TK.lattice_decode_batched(
            _t(words, cuda), _t(a, cuda), _t(u, cuda),
            s.to(cuda) if isinstance(s, torch.Tensor) else s, q=q,
            mode=mode, ref=ref.to(cuda), bucket=b)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["lattice_decode_batched"] == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("q", CARD_QS)
def test_decode_single_matches_plain(cuda, q):
    """Every mode of the single-payload decode at n = 2^20 with random
    per-bucket sides: the kernel rounds the same steps as the plain
    version, so points are bitwise too."""
    n, bucket = 1 << 20, 4096
    rng = np.random.RandomState(q + 2)
    _, u, a, sides = _inputs(n, bucket, q + 2)
    words = rng.randint(0, 1 << 32, TL.packed_len(n, TL.bits_for_q(q)),
                        dtype=np.uint64).astype(np.uint32).view(np.int32)
    ref = (0.25 * a).astype(np.float32)
    for mode, r, avg in (("coords", None, None), ("coords", ref, None),
                         ("point", None, None), ("point", ref, None),
                         ("point", None, 3), ("point", ref, 1)):
        for s, b in ((_t(sides), bucket), (float(sides[0]), None),
                     (_t(np.repeat(sides, bucket)), None)):
            rt = None if r is None else _t(r)
            want = TRef.lattice_decode_ref(
                _t(words), _t(a), _t(u), s, q=q, bits=TL.bits_for_q(q), n=n,
                avg_cnt=avg, mode=mode, ref=rt, bucket=b)
            before = _build.LAUNCHES["lattice_decode"]
            got = TK.lattice_decode(
                _t(words, cuda), _t(a, cuda), _t(u, cuda),
                s.to(cuda) if isinstance(s, torch.Tensor) else s, q=q,
                avg_cnt=avg, mode=mode,
                ref=None if rt is None else rt.to(cuda), bucket=b)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["lattice_decode"] == before + 1
            np.testing.assert_array_equal(got.cpu().numpy(), want.numpy(),
                                          err_msg=f"{mode} {avg}")


# n of the run-layout tests: 1 and 7 (inside one lane's quads), below one
# run, one past it, runs of 4 words (4 * 32/bits coordinates) less or more
# one, as few as a block holds and more than the persistent grid covers in
# one stride, and 5003
RUN_N = (1, 7, 32, 33, (5, -1), (5, 1), (131075, -1), (131075, 1), 5003)


def _run_n(q, spec):
    """n of a RUN_N entry at q: a count, or (runs, delta)."""
    if isinstance(spec, int):
        return spec
    runs, delta = spec
    return 4 * (32 // TL.bits_for_q(q)) * runs + delta


def _card_sides(sides, n):
    """(s, bucket) forms of sides drawn per 256-coordinate bucket: scalar,
    per-coordinate, per-bucket of 256 and of 8 (smaller than a 2-bit
    thread's run of 64)."""
    return (("scalar", float(sides[0].item()), None),
            ("coord", sides.repeat_interleave(256)[:n].contiguous(), None),
            ("bucket256", sides, 256),
            ("bucket8", sides.repeat_interleave(32)[:-(-n // 8)].contiguous(),
             8))


def _on_card(a, cuda, misaligned):
    """a (numpy) on the card, as a view one element past a 16-byte
    boundary when ``misaligned``."""
    t = _t(a, cuda)
    if not misaligned:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    buf[1:] = t
    v = buf[1:]
    assert v.data_ptr() % 16 != 0
    return v


@pytest.mark.parametrize("q", CARD_QS)
@pytest.mark.parametrize("n_spec", RUN_N, ids=str)
def test_encode_runs_match_plain(cuda, q, n_spec):
    """The encode against its plain version at n around whole runs, for
    every form of sides, anchored or not, with and without coords, on
    aligned tensors and on views off a 16-byte boundary; one launch a
    call."""
    n = _run_n(q, n_spec)
    bits = TL.bits_for_q(q)
    x, u, a, sides = _inputs(n, 256, q + n)
    sides_d = _t(sides, cuda)
    for misaligned in (False, True):
        xd, ud, ad = (_on_card(v, cuda, misaligned) for v in (x, u, a))
        for kind, s, b in _card_sides(sides_d, n):
            for anchor in (None, ad):
                want_w, want_k = TRef.lattice_encode_ref(
                    xd, ud, s, q=q, bits=bits, return_coords=True,
                    anchor=anchor, bucket=b)
                for coords in (False, True):
                    before = _build.LAUNCHES["lattice_encode"]
                    got = TK.lattice_encode(xd, ud, s, q=q,
                                            return_coords=coords,
                                            anchor=anchor, bucket=b)
                    torch.cuda.synchronize()
                    assert _build.LAUNCHES["lattice_encode"] == before + 1
                    w, k = got if coords else (got, None)
                    what = (f"n={n} {kind} anchored={anchor is not None} "
                            f"misaligned={misaligned}")
                    assert torch.equal(w, want_w), what
                    if coords:
                        assert torch.equal(k, want_k), what


@pytest.mark.parametrize("q", CARD_QS)
@pytest.mark.parametrize("n_spec", RUN_N, ids=str)
def test_decode_single_runs_match_plain(cuda, q, n_spec):
    """The single decode against its plain version at n around whole runs,
    in every mode (coords, coords with ref, points with ref and the
    running-average epilogue), for every form of sides, on aligned tensors
    and on views off a 16-byte boundary (words, anchor, dither, ref);
    bitwise, one launch a call."""
    n = _run_n(q, n_spec)
    bits = TL.bits_for_q(q)
    rng = np.random.RandomState(q + n + 1)
    _, u, a, sides = _inputs(n, 256, q + n + 1)
    words = rng.randint(0, 1 << 32, TL.packed_len(n, bits),
                        dtype=np.uint64).astype(np.uint32).view(np.int32)
    ref = (0.25 * a).astype(np.float32)
    sides_d = _t(sides, cuda)
    for misaligned in (False, True):
        wd, ud, ad, rd = (_on_card(v, cuda, misaligned)
                          for v in (words, u, a, ref))
        for kind, s, b in _card_sides(sides_d, n):
            for mode, r, avg in (("coords", None, None), ("coords", rd, None),
                                 ("point", None, None), ("point", rd, None),
                                 ("point", None, 3), ("point", rd, 1)):
                want = TRef.lattice_decode_ref(
                    wd, ad, ud, s, q=q, bits=bits, n=n, avg_cnt=avg,
                    mode=mode, ref=r, bucket=b)
                before = _build.LAUNCHES["lattice_decode"]
                got = TK.lattice_decode(wd, ad, ud, s, q=q, avg_cnt=avg,
                                        mode=mode, ref=r, bucket=b)
                torch.cuda.synchronize()
                assert _build.LAUNCHES["lattice_decode"] == before + 1
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (
                    f"n={n} {kind} {mode} ref={r is not None} avg={avg} "
                    f"misaligned={misaligned}")


def test_decode_single_raises_outside_the_rules(cuda):
    """Only what the reference refuses (q past 16 bits, no coordinates)
    and what no kernel takes raises on the card; 1-bit colors launch."""
    x = torch.zeros(64, device=cuda)
    w = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="q must be in"):
        TK.lattice_decode(w, x, x, 0.5, q=65537)
    with pytest.raises(ValueError, match="n >= 1"):
        TK.lattice_decode(w, x[:0], x[:0], 0.5, q=16)
    with pytest.raises(ValueError, match="is on"):
        TK.lattice_decode(w.cpu(), x, x, 0.5, q=16)
    with pytest.raises(ValueError, match="per-bucket|do not fit|shape"):
        TK.lattice_decode(w, x, x, torch.ones(3, device=cuda), q=16,
                          bucket=16)
    before = _build.LAUNCHES["lattice_decode"]
    TK.lattice_decode(w[:2], x, x, 0.5, q=2)            # 1-bit colors
    torch.cuda.synchronize()
    assert _build.LAUNCHES["lattice_decode"] == before + 1


@pytest.mark.parametrize("batched", [False, True])
def test_decode_field_holding_three_at_q3(cuda, batched):
    """A 2-bit field that holds 3 at q = 3 (a corrupted payload): the
    kernels mask by the field's width, as the plain version unpacks, and
    fold 3 as 0; every word 0xFFFFFFFF, against the plain version."""
    n, q = 5003, 3
    _, u, a, sides = _inputs(n, 256, 3)
    words = torch.full((2, TL.packed_len(n, 2)), -1, dtype=torch.int32)
    args = (_t(a), _t(u), _t(sides))
    if batched:
        want = TRef.lattice_decode_batched_ref(words, *args, q=q, bits=2,
                                               n=n, bucket=256)
        got = TK.lattice_decode_batched(words.to(cuda),
                                        *(t.to(cuda) for t in args), q=q,
                                        bucket=256)
    else:
        want = TRef.lattice_decode_ref(words[0], *args, q=q, bits=2, n=n,
                                       mode="coords", bucket=256)
        got = TK.lattice_decode(words[0].to(cuda),
                                *(t.to(cuda) for t in args), q=q,
                                mode="coords", bucket=256)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _bits(t):
    """The bit view of an f32 or bf16 tensor, on the CPU."""
    return t.view(torch.int32 if t.dtype == torch.float32
                  else torch.int16).cpu()


@pytest.mark.parametrize("d", [1 << k for k in range(2, 15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 133])
def test_fwht_matches_plain(cuda, d, dtype, rows):
    """Every row length the kernel takes, in both types, one launch a
    call.  133 rows leave the last tile ragged wherever a tile holds
    several rows (d < 4096)."""
    x = _t(np.random.RandomState(d + rows).randn(rows, d)
           .astype(np.float32)).to(dtype)
    want = TRef.fwht_ref(x)
    before = _build.LAUNCHES["fwht"]
    got = TK.fwht(x.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fwht"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (rows, d)
    # the kernel runs the plain version's stage order: equal, not just close
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwht_misaligned_view(cuda, dtype):
    """A view that does not start on a 16-byte boundary takes the kernel's
    one-element loads: ``x[1:]`` of a (rows, 4) bf16 tensor starts 8 bytes
    in, and a flat f32 view one element in starts 4 bytes in."""
    rng = np.random.RandomState(11)
    if dtype == torch.bfloat16:
        x = _t(rng.randn(301, 4).astype(np.float32)).to(dtype).to(cuda)[1:]
    else:
        x = _t(rng.randn(40 * 64 + 1).astype(np.float32)).to(cuda)[1:]
        x = x.view(40, 64)
    assert x.data_ptr() % 16 != 0
    before = _build.LAUNCHES["fwht"]
    got = TK.fwht(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fwht"] == before + 1
    assert torch.equal(_bits(got), _bits(TRef.fwht_ref(x.cpu())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,rows", [(1, 301), (2, 301), (1 << 15, 5),
                                    (1 << 16, 3), (1 << 19, 2), (1 << 20, 2),
                                    (1 << 23, 1), (1 << 24, 1), (1 << 26, 1),
                                    (1 << 27, 1)])
def test_fwht_short_and_long_rows_match_plain(cuda, d, rows, dtype):
    """Rows of 1 and 2 (one launch, no stage or one) and rows past 16,384:
    up to 2^18 one launch of the cluster kernel, up to 2^22 one of the
    fused kernel, past it the fused kernel over segments of 2^20 to 2^22,
    then one launch per group of up to 8 of the rest (2^23 to 2^30: 2
    launches), bitwise against the plain version on the card."""
    from repro_torch.kernels.fwht import fwht_passes

    g = torch.Generator(device=cuda).manual_seed(d + rows)
    x = torch.randn((rows, d), generator=g, device=cuda).to(dtype)
    want = TRef.fwht_ref(x)
    before = _build.LAUNCHES["fwht"]
    got = TK.fwht(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fwht"] == before + 1 + len(fwht_passes(d))
    assert got.dtype == dtype and tuple(got.shape) == (rows, d)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1 << 15, 1 << 16, 1 << 17, 1 << 18])
def test_fwht_cluster_rows_match_plain(cuda, d, dtype, aligned):
    """Rows of 2^15 to 2^18 take one launch of the cluster kernel (2 to 16
    blocks a row, the high index bits through distributed shared memory),
    bitwise against the plain version, on a tensor on a 16-byte boundary
    and on a view one element past it (one-element loads and stores)."""
    rows = 3
    g = torch.Generator(device=cuda).manual_seed(d)
    flat = torch.randn(rows * d + 1, generator=g, device=cuda).to(dtype)
    x = (flat[:-1] if aligned else flat[1:]).view(rows, d)
    assert (x.data_ptr() % 16 == 0) == aligned
    want = TRef.fwht_ref(x)
    before = _build.LAUNCHES["fwht"]
    got = TK.fwht(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fwht"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (rows, d)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,rows", [
    (1 << 19, 1), (1 << 19, 3), (1 << 19, 264), (1 << 20, 1), (1 << 20, 3),
    (1 << 20, 264), (1 << 21, 1), (1 << 21, 3), (1 << 22, 1), (1 << 22, 3),
    (1 << 22, 66)])
def test_fwht_fused_rows_match_plain(cuda, d, rows, dtype, aligned):
    """Rows of 2^19 to 2^22 take one launch of the fused kernel (low and
    high items in ticket order, the intermediate f32 in the output or, for
    bf16, in a ring of rows), bitwise against the plain version, on a
    tensor on a 16-byte boundary and on a view one element past it; 1 and
    3 rows fill no lag of rows, 264 and 66 reuse the ring's slots.  A
    second call gives the same bits (the kernel left its counters 0)."""
    g = torch.Generator(device=cuda).manual_seed(d + rows)
    flat = torch.randn(rows * d + 1, generator=g, device=cuda).to(dtype)
    x = (flat[:-1] if aligned else flat[1:]).view(rows, d)
    assert (x.data_ptr() % 16 == 0) == aligned
    want = TRef.fwht_ref(x)
    before = _build.LAUNCHES["fwht"]
    got = TK.fwht(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fwht"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (rows, d)
    assert torch.equal(_bits(got), _bits(want))
    again = TK.fwht(x)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fwht"] == before + 2
    assert torch.equal(_bits(again), _bits(got))


@pytest.mark.parametrize("anchored", [False, True])
def test_round_on_card_bitwise_equals_cpu_round(cuda, anchored):
    spec = wire.RoundSpec(round_id=3, d=3000,
                          cfg=QSyncConfig(q=16, bucket=256), y0=0.5, seed=9)
    rng = np.random.RandomState(1)
    base = rng.randn(spec.d).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(6, spec.d).astype(np.float32)
    if anchored:
        from repro_torch.agg import rounds
        import dataclasses
        spec = dataclasses.replace(spec,
                                   anchor_digest=rounds.anchor_digest(base))
    means = []
    for dev in (cuda, "cpu"):
        server = AggServer(spec, base, device=dev)
        for i in range(len(xs)):
            c = AggClient(spec, i, xs[i], anchor=base if anchored else None,
                          device=dev)
            server.receive(c.payload())
        means.append(server.finalize()[0].cpu().numpy())
    np.testing.assert_array_equal(means[0], means[1])


def test_star_over_nccl_matches_cpu(cuda):
    """A one-rank NCCL group (tensors cross as they are, no host staging):
    the star's mean and telemetry on the card equal the CPU's bit for
    bit."""
    import socket

    import torch.distributed as dist
    from repro_torch import random as TR
    from repro_torch.dist import collectives as TC

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        gloo = dist.new_group(backend="gloo")
        x = np.random.RandomState(3).randn(5000).astype(np.float32)
        cfg = QSyncConfig(q=16, bucket=1024)
        outs = []
        for dev, group in ((cuda, None), ("cpu", gloo)):
            o, aux = TC.allgather_allreduce_mean(
                _t(x, dev), torch.full((5,), 0.5, device=dev), TR.PRNGKey(4),
                cfg, group)
            outs.append((o.cpu().numpy(), aux.dist_b.cpu().numpy()))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
    finally:
        dist.destroy_process_group()


def _qkv(bh, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(_t(rng.randn(bh, s, d).astype(np.float32))
                 for s in (sq, sk, sk))


# (rtol, atol) of the kernels against the plain version on the card: both
# compute in f32 and round once to the output type
_FLASH_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-5),
              torch.float16: (2e-3, 1e-5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 20, 32, 48, 64, 100, 128, 192, 200, 256])
@pytest.mark.parametrize("sq,sk,causal", [(256, 256, True), (256, 256, False),
                                          (80, 80, True), (256, 1024, False),
                                          (512, 256, False), (64, 200, False),
                                          (300, 300, True), (8, 256, False),
                                          (8, 256, True), (1, 1, True),
                                          (1000, 1000, True)])
def test_flash_attention_matches_plain(cuda, dtype, d, sq, sk, causal):
    """Online softmax in tiles against the plain softmax (f32 on the tensor
    cores as three TF32 products, bf16 and f16 on wgmma with P split into
    two terms): f32 inside, sums in another order; f32 at rtol = atol =
    2e-4.  Both round once to the output type, so bf16 outputs differ by at
    most one bf16 step, 2^-7 of the value (rtol = 1e-2, atol = 1e-5), and
    f16 outputs by one f16 step, 2^-10 of the value (rtol = 2e-3, atol =
    1e-5).  (80, 80) leaves a ragged tile of queries and keys; in (64, 200)
    the last key tile is ragged, and TMA fills it with zeros, which must
    be masked; (300, 300), (8, 256), (1, 1) and (1000, 1000) are shapes
    the reference sends to its plain version.  bf16 and f16 run D 16 and
    32 as they are and 20 and 48 padded to 32 and 64; f32 runs every D
    below 64 padded to 64; 100 and 200 run padded to 128 and 256; one
    launch."""
    q, k, v = (a.to(dtype) for a in _qkv(3, sq, sk, d, seed=d + sq))
    want = TRef.flash_attention_ref(q, k, v, causal=causal)
    before = _build.LAUNCHES["flash_attention"]
    got = TK.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
    rtol, atol = _FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=rtol, atol=atol)


def test_flash_attention_bf16_long_causal(cuda):
    """bf16, causal, BH 2, S = 8,192, D = 128: long rows, where P rounded
    once to bf16 moves a few percent of the outputs by more than one bf16
    step from the plain version's (which keeps P in f32).  The split P
    holds the same limit as the short cases, rtol = 1e-2, atol = 1e-5.
    The plain version runs on the card."""
    q, k, v = (a.to(torch.bfloat16).to(cuda)
               for a in _qkv(2, 8192, 8192, 128, seed=8192))
    want = TRef.flash_attention_ref(q, k, v, causal=True)
    got = TK.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=1e-2,
                               atol=1e-5)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_attention_f16_long_causal(cuda, d):
    """The same long causal rows in f16 (P split into two f16 terms), at
    D 128 and 256, within the f16 limits of the short cases."""
    q, k, v = (a.to(torch.float16).to(cuda)
               for a in _qkv(2, 8192, 8192, d, seed=8192))
    want = TRef.flash_attention_ref(q, k, v, causal=True)
    got = TK.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    rtol, atol = _FLASH_TOL[torch.float16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bh_past_grid_y(cuda, dtype):
    """BH = 70,000 > 65,535 (the limit of a grid's second dimension) in one
    launch; every row of BH against the plain version."""
    q, k, v = (a.to(dtype).to(cuda) for a in _qkv(70_000, 16, 16, 64, seed=7))
    before = _build.LAUNCHES["flash_attention"]
    got = TK.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    want = TRef.flash_attention_ref(q, k, v, causal=True)
    rtol, atol = _FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [257, 320, 384, 512, 640, 1000])
@pytest.mark.parametrize("sq,sk,causal", [(256, 256, True), (300, 300, False),
                                          (8, 256, True), (80, 200, False)])
def test_flash_attention_wide_head_dims_match_plain(cuda, dtype, d, sq, sk,
                                                    causal):
    """Head dims past 256 against the plain version, at the limits of the
    narrow kernels' tests; one launch.  bf16 and f16 up to 512 take the
    wide wgmma kernel (the scores shared by two warpgroups, P split), f32
    and every type past 512 the wide f32 kernel (three TF32 products for
    each f32 one, P and every sum in f32; past 512 the output columns in
    groups of 512 over the grid);
    257 and 320 run padded to 384, 640 and 1000 to 1024."""
    q, k, v = (a.to(dtype) for a in _qkv(3, sq, sk, d, seed=d + sq))
    want = TRef.flash_attention_ref(q, k, v, causal=causal)
    before = _build.LAUNCHES["flash_attention"]
    got = TK.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
    rtol, atol = _FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sk", [1, 511, 4096, 32768])
@pytest.mark.parametrize("sq", [1, 8, 16])
def test_flash_attention_split_matches_plain(cuda, dtype, sq, sk):
    """Few queries over many keys, not causal: the split kernel (over BH 3
    a split for each 256 keys up to one or two blocks an SM and 64: one at
    Sk 1, two at 511, 16 at 4,096, 44 to 64 at 32,768), one launch, within
    the limits
    of the other kernels' tests; a second call reuses the stream's
    counters, which the first must have left at 0."""
    from repro_torch.kernels.flash_attention import kernel_of

    assert kernel_of(dtype, 128, sq, False)[0] == "flash_attention_split"
    q, k, v = (a.to(dtype) for a in _qkv(3, sq, sk, 128, seed=sq + sk))
    want = TRef.flash_attention_ref(q, k, v, causal=False)
    before = _build.LAUNCHES["flash_attention"]
    got = TK.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=False)
    again = TK.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                               causal=False)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 2
    assert got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
    rtol, atol = _FLASH_TOL[dtype]
    for out in (got, again):
        np.testing.assert_allclose(out.float().cpu().numpy(),
                                   want.float().numpy(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 100, 128, 192, 256])
def test_flash_attention_split_head_dims_and_bits(cuda, dtype, d):
    """The split kernel at every head dim it is built for (f32 from 64;
    48 and 100 padded), BH 64, 8 queries over 4,096 keys (one to four
    splits), against the plain version on the card; two calls give the
    same bits (the splits are merged in a fixed order)."""
    q, k, v = (a.to(dtype).to(cuda) for a in _qkv(64, 8, 4096, d, seed=d))
    got = TK.flash_attention(q, k, v, causal=False)
    again = TK.flash_attention(q, k, v, causal=False)
    want = TRef.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16 if dtype != torch.float32
                                else torch.int32),
                       again.view(torch.int16 if dtype != torch.float32
                                  else torch.int32))
    rtol, atol = _FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_split_limits(cuda, dtype):
    """The split kernel's library states the limits that the CPU tests of
    ``split_plan`` take (64 splits; keys of one tile for each of four warps,
    32 in f32 and 64 in bf16 and f16), and at least one block of every
    built head dim fits on each SM."""
    from repro_torch.kernels import flash_attention as FA

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = (64, 32) if dtype == torch.float32 else (64, 64)
    for d in FA.HEAD_DIMS:
        if dtype == torch.float32 and d < 64:
            continue
        blocks, max_splits, align = FA._split_limits(dtype, d,
                                                     cuda.index or 0)
        assert blocks >= sms and (max_splits, align) == want, d


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_attention_wgmma_residency(cuda, dtype):
    """The wgmma kernel's library states each instance's residency: up to
    head dim 32 at least four consumer warpgroups of 64 query rows on each
    SM (twice the two of one 384-thread block with a producer warpgroup),
    at 64 at least three (four spill there), above it one such block an
    SM; every instance within 255 registers a thread."""
    from repro_torch.kernels import flash_attention as FA

    for d in FA.HEAD_DIMS:
        blocks, consumers, regs = FA.wgmma_residency(dtype, d,
                                                     cuda.index or 0)
        if d <= 64:
            want = 4 if d <= 32 else 3
            assert blocks * consumers >= want, (d, blocks, consumers)
        else:
            assert (blocks, consumers) == (1, 2), (d, blocks, consumers)
        assert 0 < regs <= 255, (d, regs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_small_head_dims_same_bits(cuda, dtype, d, causal):
    """bf16 and f16 at head dims 16, 32 and 64 (BH 3, Sq = Sk = 1,000:
    ragged query and key tiles) give the same bits on two calls, within
    the limits of ``test_flash_attention_matches_plain``."""
    q, k, v = (a.to(dtype).to(cuda) for a in _qkv(3, 1000, 1000, d,
                                                   seed=d + 1))
    got = TK.flash_attention(q, k, v, causal=causal)
    again = TK.flash_attention(q, k, v, causal=causal)
    want = TRef.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    rtol, atol = _FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("bh,sq,sk,causal", [(1, 1, 1, True),
                                             (1, 64, 64, True),
                                             (1, 200, 4096, False),
                                             (1, 17, 4096, False),
                                             (2, 256, 256, True),
                                             (3, 300, 70, False),
                                             (5, 1000, 1000, True)])
def test_flash_attention_small_grids(cuda, dtype, d, bh, sq, sk, causal):
    """Grids of fewer blocks than the card has SMs at head dims 16, 32 and
    64: one query tile of BH 1 (one row, one block of 64 rows, 200 rows
    over 4,096 keys, 17 rows: past the split kernel's 16), a block's rows
    past Sq, keys fewer than the rows; one launch, against the plain
    version at the limits of ``test_flash_attention_matches_plain``."""
    q, k, v = (a.to(dtype).to(cuda) for a in _qkv(bh, sq, sk, d,
                                                   seed=bh + sq + sk))
    before = _build.LAUNCHES["flash_attention"]
    got = TK.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    want = TRef.flash_attention_ref(q, k, v, causal=causal)
    rtol, atol = _FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_attention_small_long_causal(cuda, dtype, d):
    """Causal S = 4,096 (BH 2) at head dims 16, 32 and 64: 64 key tiles a
    row at the end, every ring stage reused many times; against the plain
    version on the card at the limits of the short cases."""
    q, k, v = (a.to(dtype).to(cuda) for a in _qkv(2, 4096, 4096, d,
                                                   seed=4096 + d))
    got = TK.flash_attention(q, k, v, causal=True)
    want = TRef.flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    rtol, atol = _FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=rtol,
                               atol=atol)


def test_flash_attention_raises_outside_the_rules(cuda):
    """A dtype no kernel is built for raises on the card, at a head dim
    past 256 too; nothing launches.  D 320 launches a wide kernel."""
    before = _build.LAUNCHES["flash_attention"]
    for d in (64, 320):
        q, k, v = (a.to(cuda).double() for a in _qkv(2, 256, 256, d, seed=0))
        with pytest.raises(ValueError, match="f32, bf16 or f16"):
            TK.flash_attention(q, k, v)
    assert _build.LAUNCHES["flash_attention"] == before
    q, k, v = (a.to(cuda) for a in _qkv(2, 256, 256, 320, seed=0))
    TK.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1


def test_dme_on_card_bitwise_equals_cpu(cuda):
    """The paper's algorithms draw and compute on the inputs' device; the
    card's outputs equal the CPU's bit for bit."""
    from repro_torch import random as TR
    from repro_torch.core import compressors as TCmp
    from repro_torch.core import dme as TD
    from repro_torch.core import error_detect as TE

    rng = np.random.RandomState(0)
    xs = (rng.randn(4096) * 100 + 0.05 * rng.randn(8, 4096)).astype(np.float32)
    y = float(2 * np.abs(xs - xs.mean(0)).max())
    runs = (lambda X: TD.mean_estimation_star(X, y, TCmp.LatticeQ(q=16),
                                              TR.PRNGKey(1)),
            lambda X: TD.mean_estimation_tree(X, y, m=8, key=TR.PRNGKey(2)),
            lambda X: TD.butterfly_mean(X, y, TCmp.LatticeQ(q=16),
                                        TR.PRNGKey(3)),
            lambda X: TD.variance_reduction(X, 0.05, TCmp.LatticeQ(q=64),
                                            TR.PRNGKey(4)))
    for fn in runs:
        a, b = fn(_t(xs, cuda)), fn(_t(xs))
        np.testing.assert_array_equal(a.est.cpu().numpy().view(np.uint32),
                                      b.est.numpy().view(np.uint32))
        assert bool(a.decode_ok) and bool(b.decode_ok)
    xu = xs[0]
    ra = [TE.robust_agreement(_t(xu, dv), _t(xu + 0.3, dv), 0.01, 16,
                              TR.PRNGKey(5)) for dv in (cuda, "cpu")]
    assert (ra[0]["iters"], ra[0]["bits"], ra[0]["ok"]) == \
        (ra[1]["iters"], ra[1]["bits"], ra[1]["ok"])
    assert ra[0]["ok"] and ra[0]["iters"] >= 2
    np.testing.assert_array_equal(ra[0]["z"].cpu().numpy(), ra[1]["z"].numpy())


def test_service_tree_and_engine_on_card_bitwise_equal_cpu(cuda):
    """A two-round anchored service chain, a 2-tier tree and an open-loop
    engine run give the same bits on the card as on the CPU."""
    from repro_torch.agg import sim
    from repro_torch.agg.service import AggService, ServiceConfig
    from repro_torch.agg.tree import AggTree

    d = 4096
    rng = np.random.RandomState(3)
    base = rng.randn(d).astype(np.float32)
    xs = base[None] + 0.02 * rng.randn(12, d).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        svc = AggService(ServiceConfig(d=d, bucket=512, y0=0.5),
                         anchor0=base, device=dev)
        means = []
        for _ in range(2):
            spec, anchor = svc.begin_round()
            server = svc.make_server()
            for f in sim.fleet_payloads(spec, xs[:6], anchor=anchor,
                                        device=dev):
                server.receive(f)
            means.append(svc.end_round(server)[0].cpu())
        spec = wire.RoundSpec(round_id=1, d=d,
                              cfg=QSyncConfig(q=16, bucket=512), y0=0.5)
        tree = AggTree(spec, base, fanout=2, tiers=2, device=dev)
        for fs in sim.fleet_frames(spec, xs, device=dev):
            for f in fs:
                tree.ingest_frame(f)
        tree.tick()
        tree.seal()
        for _ in range(16):
            tree.tick()
            if tree.published():
                break
        means.append(tree.published()[0].mean.cpu())
        rep = sim.run_open_loop(sim.OpenLoopConfig(duration=0.2),
                                check_parity=dev == "cuda", device=dev)
        means.extend(pr.mean.cpu() for pr in rep.published)
        out[dev] = means
    assert len(out["cuda"]) == len(out["cpu"]) >= 4
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_fsdp_train_step_on_card(cuda):
    """internvl2-smoke on a one-rank NCCL group, unrotated and rotated: a
    train step on the card gives a finite loss and no decode failures, and
    the FSDP backward of every leaf length the model has, given one seeded
    cotangent, equals the CPU port's (over a gloo group) bit for bit."""
    import socket

    import torch.distributed as dist
    from repro_torch import random as TR
    from repro_torch.configs import registry
    from repro_torch.dist import fsdp as TF
    from repro_torch.models import transformer as TT
    from repro_torch.models.sharding import ShardCtx, leaf_gathered_len
    from repro_torch.train import data as TD
    from repro_torch.train import optim as TO
    from repro_torch.train import trainer as TTr

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        gloo = dist.new_group(backend="gloo")
        cfg = registry.smoke_config("internvl2-1b")
        for rotate in (False, True):
            qc = QSyncConfig(q=16, bucket=64, rotate=rotate)
            ctx = ShardCtx(dp=1, qcfg=qc)
            tc = TTr.TrainConfig()
            step = TTr.make_train_step(cfg, ctx, TO.OptConfig(), tc, cuda)
            state = TTr.init_state(cfg, ctx, TO.OptConfig(), tc,
                                   TR.PRNGKey(0), dp_rank=0, device=cuda)
            data = TD.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
            batch = TD.batch_at(data, 0, device=cuda)
            batch["img"] = TD.frames_at(data, 0, cfg.img_tokens, cfg.d_model,
                                        device=cuda)
            _, metrics = step(state, batch)
            assert np.isfinite(float(metrics["loss"]))
            assert float(metrics["fails"]) == 0
            metas = TT.all_metas(cfg, ctx)
            lengths = sorted({leaf_gathered_len(m, ctx)
                              for g in metas.values() for m in g.values()})
            for m in lengths:
                rng = np.random.RandomState(m)
                w = rng.randn(m).astype(np.float32)
                ct = rng.randn(m).astype(np.float32)
                nb = TF.leaf_nb(m, 1, qc)
                outs = []
                for dev, group in ((cuda, None), ("cpu", gloo)):
                    fcfg = TF.FSDPConfig(axes=(group,), qcfg=qc)
                    wt = _t(w, dev).requires_grad_()
                    tele = torch.zeros(TF.tele_width(nb), device=dev,
                                       requires_grad=True)
                    full = TF.make_fsdp_gather(fcfg)(
                        {"w": wt, "y": torch.full((nb,), 0.5, device=dev),
                         "key": TR.PRNGKey(m), "tele": tele})
                    full.backward(_t(ct, dev).to(full.dtype))
                    outs.append((wt.grad.cpu().numpy(),
                                 tele.grad.cpu().numpy()))
                np.testing.assert_array_equal(outs[0][0], outs[1][0])
                np.testing.assert_array_equal(outs[0][1], outs[1][1])
    finally:
        dist.destroy_process_group()


_MOE_RANK = """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import registry
from repro_torch.models import moe as M
from repro_torch.models import sharding as S

rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
cfg = registry.smoke_config("granite-moe-1b-a400m")
ctx = S.ShardCtx(tp=2, dp=1)
D, F, e_loc = cfg.d_model, cfg.d_ff, cfg.n_experts // 2
rng = np.random.RandomState(rank)
x = rng.randn(48, D).astype(np.float32)
rows = rng.randn(cfg.n_experts, 16, D).astype(np.float32)
ct = rng.randn(48, D).astype(np.float32)
w = {"router": np.random.RandomState(9).randn(D, cfg.n_experts) / 8}
for k, shp in (("w1", (D, F)), ("w3", (D, F)), ("w2", (F, D))):
    w[k] = rng.randn(e_loc, *shp) / np.sqrt(shp[0])
outs = {}
for dev in ("cuda", "cpu"):
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    xt = t(x).requires_grad_()
    wt = {k: t(v).requires_grad_() for k, v in w.items()}
    a2a = S.all_to_all_tp(t(rows), ctx, 0, 1)
    o, aux = M.moe_mlp(xt, wt, cfg, ctx)
    (torch.sum(o * t(ct)) + aux).backward()
    outs[dev] = [a2a, o, aux, xt.grad] + [wt[k].grad for k in sorted(wt)]
card, cpu = [[v.detach().cpu() for v in outs[d]] for d in ("cuda", "cpu")]
assert torch.equal(card[0], cpu[0]), "all-to-all: card != CPU"
assert card[0].shape == (cfg.n_experts // 2, 32, D)
for i, (a, b) in enumerate(zip(card[1:], cpu[1:])):
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=str(i))
dist.destroy_process_group()
print("ok", rank)
"""


def test_moe_all_to_all_and_mlp_on_card(cuda):
    """Two ranks sharing the card over gloo (the TP group, 4 experts
    each): the tiled all-to-all on the card equals the CPU's bit for bit,
    and ``moe_mlp`` (output, aux, the input's and weights' gradients) at
    f32 within rtol 1e-5 (no TF32)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", _MOE_RANK, str(r),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-5000:]}"


def test_serve_step_on_card_matches_cpu(cuda):
    """glm4-smoke's serve step, one rank, 6 teacher-forced steps with the
    bf16 and the int8 cache: the card's caches within
    ``test_torch_serve.py``'s tolerances of the CPU's (5e-2 of the largest
    entry; int8 within 4), its tokens the CPU's except on rows whose top
    two logits (the CPU's) are within 1e-2, no more than one in eight."""
    from repro_torch import random as R
    from repro_torch.configs import registry
    from repro_torch.models import serve as SV
    from repro_torch.models import sharding as S
    from repro_torch.models import transformer as T

    cfg = registry.smoke_config("glm4-9b")
    ctx = S.ShardCtx()
    params = {g: {k: v.to(torch.bfloat16) for k, v in t.items()} for g, t in
              T.init_params(cfg, ctx, R.PRNGKey(0), device="cpu").items()}
    feeds = np.random.RandomState(3).randint(0, cfg.vocab, (6, 4, 1))
    greedy = SV._greedy
    for kvq in (False, True):
        got = {}
        for dev in ("cpu", cuda):
            gaps = []

            def recorded(x, head, ctx_):
                top = torch.topk(x.float() @ head.float().T, 2).values
                gaps.append(((top[:, 0] - top[:, 1])
                             / top[:, 0].abs()).cpu().numpy())
                return greedy(x, head, ctx_)

            SV._greedy = recorded
            try:
                p = {g: {k: v.to(dev) for k, v in t.items()}
                     for g, t in params.items()}
                cache = SV.cache_zeros(cfg, ctx, 4, 16, kv_quant=kvq,
                                       device=dev)
                step = SV.make_serve_step(cfg, ctx, kv_quant=kvq)
                toks = []
                for t, feed in enumerate(feeds):
                    nxt, cache = step(p, cache, _t(feed, dev), t,
                                      R.PRNGKey(1))
                    toks.append(nxt.cpu().numpy())
            finally:
                SV._greedy = greedy
            got[str(dev)] = (np.stack(toks), cache, np.stack(gaps))
        (t_cpu, c_cpu, gap), (t_gpu, c_gpu, _) = got["cpu"], got[str(cuda)]
        for k, want in c_cpu.items():
            have = c_gpu[k].cpu()
            assert have.dtype == want.dtype, k
            err = (have.float() - want.float()).abs().max()
            if want.dtype == torch.int8:
                assert float(err) <= 4, (k, float(err))
            else:
                assert float(err) <= 5e-2 * float(want.float().abs().max()), k
        differ = t_cpu != t_gpu
        assert not np.any(differ & (gap >= 1e-2)), (t_cpu, t_gpu, gap)
        assert differ.sum() * 8 <= differ.size
