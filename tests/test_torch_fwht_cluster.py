"""The FWHT's launch plan past 16,384 coordinates, on the CPU.

Rows of 2^15 to 2^18 take one launch of ``csrc/fwht.cu``'s cluster
kernel: each block of a cluster runs index bits 0-13 of its chunk of
16,384 coordinates, then the blocks exchange columns and run the high bits
across chunks, f32 between, one scale at the end.  Rows of 2^19 to 2^22
take one launch of the fused kernel: low items run the tile kernel's
passes over the low 12 to 14 bits, high items the bits past them,
in the order of a ticket that puts a row's high items ``FUSED_LAG`` rows
behind its low ones.  Longer rows take the fused kernel over segments of
2^20 to 2^22, unscaled, then one launch per group of the rest
(``kernels.fwht.fwht_passes``).  Here a torch model of exactly that
decomposition is held bitwise to the plain version (``fwht_ref``), which
is held to the reference's ``ops.fwht``, and a model of the fused
kernel's tickets is checked for its waits; the kernel itself is held
bitwise to the plain version on the card in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro_torch.kernels import _build, ops
from repro_torch.kernels import fwht as F
from repro_torch.kernels import ref


def _stages(v, lo, hi):
    """The butterflies over index bits lo .. hi - 1 of the last axis,
    lowest first, (a, b) -> (a + b, a - b) with a the lower index; f32."""
    lead, d = v.shape[:-1], v.shape[-1]
    for b in range(lo, hi):
        h = 1 << b
        v = v.reshape(lead + (d // (2 * h), 2, h))
        v = torch.stack([v[..., 0, :] + v[..., 1, :],
                         v[..., 0, :] - v[..., 1, :]], dim=-2)
    return v.reshape(lead + (d,))


def _chunks_then_cluster(v, log2d):
    """The cluster kernel over index bits 0 .. log2d - 1 of rows of v (f32,
    unscaled): each chunk of 2^14 its bits 0-13 on its own, in the
    kernel's three register passes (0-4, 5-9, 10-13), then the bits past
    13 across chunks, bit 14 first."""
    rows = v.shape[0]
    c = v.reshape(rows, -1, F.TILE_D)
    for lo, hi in ((0, 5), (5, 10), (10, F.TILE_LOG2)):
        c = _stages(c, lo, hi)
    x = c.reshape(rows, -1, 1 << log2d)
    chunks = x.reshape(rows, -1, 1 << (log2d - F.TILE_LOG2), F.TILE_D)
    chunks = _stages(chunks.transpose(-1, -2),
                     0, log2d - F.TILE_LOG2).transpose(-1, -2)
    return chunks.reshape(v.shape)


def _low_bits(log2d):
    """The fused kernel's low items' index bits at rows of 2^log2d: all but
    7 up to 2^20, all but 8 past it."""
    return log2d - (7 if log2d <= 20 else 8)


def _tile_then_high(v, log2d):
    """The fused kernel over index bits 0 .. log2d - 1 of rows of v (f32,
    unscaled): each low item's 2^s coordinates (``_low_bits``) its bits 0
    .. s - 1 in the tile kernel's register passes (0-3, 4-7, 8-11, then
    what is left), then each high item's tiles the bits from s on, four in
    registers, the rest through shared memory."""
    rows = v.shape[0]
    s = _low_bits(log2d)
    c = v.reshape(rows, -1, 1 << s)
    for lo in range(0, s, 4):
        c = _stages(c, lo, min(lo + 4, s))
    k0 = min(s + 4, log2d)
    x = _stages(c.reshape(rows, 1 << log2d), s, k0)
    return _stages(x, k0, log2d).reshape(v.shape)


def plan_model(x):
    """The card's launches for rows of ``x`` past 16,384, in torch: the
    cluster kernel up to 2^18, the fused kernel up to 2^22, over all the
    bits where there is no further pass, else the fused kernel over the
    bits below the first pass's (segments of 2^20 to 2^22), then each of
    ``fwht_passes`` over its bits, f32 between, one scale, then the input
    type."""
    d = x.shape[-1]
    log2d = d.bit_length() - 1
    passes = F.fwht_passes(d)
    first = passes[0][0] if passes else log2d
    v = x.to(torch.float32).reshape(-1, 1 << first)
    whole = (_chunks_then_cluster if first <= F.CLUSTER_LOG2
             else _tile_then_high)
    v = whole(v, first).reshape(x.shape)
    for b0, k in passes:
        v = _stages(v, b0, b0 + k)
    scale = float(np.float32(1.0 / np.sqrt(d)))
    return (v * scale).to(x.dtype)


def ticket_order(rows, lag, nl):
    """The fused kernel's items in ticket order, as (high, row, item), by
    the arithmetic of its C code: groups of ``nl`` items, the low rows 0
    .. lag first, then high row j before low row lag + 1 + j, then the high
    rows left."""
    head, pairs = min(rows, lag + 1), max(0, rows - lag - 1)
    out = []
    for t in range(2 * rows * nl):
        g, item = divmod(t, nl)
        if g < head:
            high, r = False, g
        elif g < head + 2 * pairs:
            k = g - head
            high = k % 2 == 0
            r = k // 2 if high else lag + 1 + k // 2
        else:
            high, r = True, g - head - pairs
        out.append((high, r, item))
    return out


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("d,launches,first", [
    (1 << 4, 1, None), (1 << 14, 1, None), (1 << 15, 1, None),
    (1 << 16, 1, None), (1 << 17, 1, None), (1 << 18, 1, None),
    (1 << 19, 1, None), (1 << 20, 1, None), (1 << 22, 1, None),
    (1 << 23, 2, 20), (1 << 26, 2, 20), (1 << 27, 2, 20), (1 << 28, 2, 20),
    (1 << 29, 2, 21), (1 << 30, 2, 22), (1 << 31, 3, 22)])
def test_launch_plan(d, launches, first):
    """Up to 2^22 one launch; past it a first launch over the low 20 to 22
    bits (the fused kernel over segments, the shortest that leave at most
    8 bits) and one launch per group of at most 8 of the rest, groups as
    even as can be, covering every bit once and in order."""
    passes = F.fwht_passes(d)
    assert 1 + len(passes) == launches
    assert (passes[0][0] if passes else None) == first
    bits = list(range(passes[0][0] if passes else d.bit_length() - 1))
    assert len(bits) <= F.FUSED_LOG2
    for b0, k in passes:
        assert 1 <= k <= F.HIGH_BITS and b0 == len(bits)
        bits += range(b0, b0 + k)
    assert bits == list(range(d.bit_length() - 1))
    if passes:
        assert max(k for _, k in passes) - min(k for _, k in passes) <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1 << 15, 1 << 16, 1 << 17, 1 << 18])
def test_fake_takes_one_launch_up_to_2_18(d, dtype):
    """The shape-only implementation records one launch for rows of up to
    2^18, reading x and writing the output of its type: no f32 scratch for
    bf16."""
    seen = []
    _build.reset_launch_counts()
    _build.FAKE_OBSERVERS.append(lambda k, i, o: seen.append((k, i, o)))
    try:
        y = ops.fwht(torch.empty(2, d, dtype=dtype, device="meta"))
        assert y.dtype == dtype and tuple(y.shape) == (2, d)
        assert _build.FAKE_LAUNCHES["fwht"] == 1
        assert [(i[0].dtype, o[0].dtype) for _, i, o in seen] == [(dtype,
                                                                   dtype)]
    finally:
        _build.FAKE_OBSERVERS.pop()
        _build.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,rows", [(1 << 15, 3), (1 << 17, 2), (1 << 19, 2),
                                    (1 << 20, 1), (1 << 22, 1), (1 << 23, 1)])
def test_decomposition_is_bitwise_the_plain_version(d, rows, dtype):
    """The model of the card's decomposition (chunks of 2^14 in three
    register passes, the high bits across chunks; past 2^18 the tile
    kernel's passes over the low 12 to 14 bits, then the high bits in two
    rounds; past 2^22 that over segments, then the further passes; f32
    between, one scale) gives the plain version's bits, f32 and bf16
    (rounded once at the end)."""
    x = torch.from_numpy(np.random.RandomState(d + rows).randn(rows, d)
                         .astype(np.float32)).to(dtype)
    assert torch.equal(_bits(plan_model(x)), _bits(ref.fwht_ref(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1 << 15, 1 << 17])
def test_plain_version_matches_reference(d, dtype):
    """The plain version against the reference's ``ops.fwht`` (its plain
    ``fwht_jnp`` past 16,384) at rows the cluster kernel takes: the same
    stages in the same order, so the same bits."""
    x = np.random.RandomState(d).randn(2, d).astype(np.float32)
    want = JK.fwht(jnp.asarray(x).astype(dtype))
    got = ops.fwht(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1 << 19, 1 << 20, 1 << 21, 1 << 22])
def test_fake_takes_one_launch_up_to_2_22(d, dtype):
    """The shape-only implementation records one launch for rows of 2^19
    to 2^22, reading x and writing the output of its type; bf16 also
    writes the fused kernel's ring of f32 rows, fewer than the tensor's:
    no f32 scratch of the whole tensor."""
    rows = 16
    seen = []
    _build.reset_launch_counts()
    _build.FAKE_OBSERVERS.append(lambda k, i, o: seen.append((k, i, o)))
    try:
        x = torch.empty(rows, d, dtype=dtype, device="meta")
        y = ops.fwht(x)
        assert y.dtype == dtype and tuple(y.shape) == (rows, d)
        assert _build.FAKE_LAUNCHES["fwht"] == 1
        [(_, ins, outs)] = seen
        assert ins[0] is x and outs[0].dtype == dtype
        if dtype == torch.float32:
            assert len(outs) == 1
        else:
            slots = F.ring_slots(d, rows)
            assert slots == F.FUSED_LAG[d.bit_length() - 1] + F.RING_EXTRA
            assert slots < rows
            assert [(o.dtype, tuple(o.shape)) for o in outs[1:]] == [
                (torch.float32, (slots, d))]
    finally:
        _build.FAKE_OBSERVERS.pop()
        _build.reset_launch_counts()


def _simulate(order, rows, nl, slots, resident, seed):
    """Run the fused kernel's items as the card may: blocks start in
    ticket order while fewer than ``resident`` run, and any running block
    whose wait is met may finish next (picked at random).  A low item of
    row r writes ring slot r % slots once the high items of row r - slots
    are done, a high item reads the slot once its row's low items are
    published.  Returns the events (kind, row, slot) in order; fails on a
    deadlock."""
    rng = np.random.RandomState(seed)
    lows, highs = [0] * rows, [0] * rows
    running, nxt, events = [], 0, []
    while nxt < len(order) or running:
        while nxt < len(order) and len(running) < resident:
            running.append(nxt)
            nxt += 1

        def ready(t):
            high, r, _ = order[t]
            if high:
                return lows[r] == nl
            return r < slots or highs[r - slots] == nl
        can = [t for t in running if ready(t)]
        assert can, f"deadlock with {resident} resident blocks"
        t = can[rng.randint(len(can))]
        running.remove(t)
        high, r, _ = order[t]
        if high:
            highs[r] += 1
            events.append(("read", r, r % slots))
        else:
            lows[r] += 1
            events.append(("write", r, r % slots))
    return events


@pytest.mark.parametrize("log2d", [19, 20, 21, 22])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 9, 10, 11, 33, 264])
def test_fused_ticket_order(log2d, rows):
    """The fused kernel's tickets take every item once; each wait (a high
    item on its row's low items, a bf16 low item on the high items of its
    ring slot's last row) is on lower tickets only, so a block waits only
    on blocks already running; and run in any order those waits allow,
    with 1 to 132 blocks resident, nothing deadlocks, a high item reads
    its row after all of the row's low items wrote it, and a ring slot is
    written again only after the high items of its last row read it."""
    nl = 1 << (log2d - _low_bits(log2d))
    lag = F.FUSED_LAG[log2d]
    order = ticket_order(rows, lag, nl)
    assert sorted(order) == sorted(
        (h, r, i) for h in (False, True) for r in range(rows)
        for i in range(nl))
    ticket = {w: t for t, w in enumerate(order)}
    slots = F.ring_slots(1 << log2d, rows)
    assert slots >= min(rows, lag + 1)
    for t, (high, r, _) in enumerate(order):
        if high:
            waits = [ticket[False, r, j] for j in range(nl)]
        elif r >= slots:
            waits = [ticket[True, r - slots, j] for j in range(nl)]
        else:
            waits = []
        assert all(w < t for w in waits)
    if rows * nl > 2048:
        return  # the waits above cover it; the simulation is quadratic
    for resident in (1, 7, 132):
        events = _simulate(order, rows, nl, slots, resident, seed=rows)
        held = {}      # slot -> (row, writes, reads)
        for kind, r, s in events:
            row, w, rd = held.get(s, (r, 0, 0))
            if kind == "write":
                if row != r:   # a new row in the slot: the last one read
                    assert w == nl and rd == nl, (s, row, r)
                    w, rd = 0, 0
                held[s] = (r, w + 1, rd)
            else:
                assert row == r and w == nl
                held[s] = (r, w, rd + 1)
