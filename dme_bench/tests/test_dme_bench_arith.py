"""The benchmark's arithmetic on synthetic spans and traces: the window,
the rate, the percentile, busy and idle time, kernel shares, byte counts,
and inputs drawn from the seed."""
import random

import numpy as np
import pytest
import torch

from dme_bench import harness as H
from dme_bench import inputs, roofline
from dme_bench import trace as TR


@pytest.mark.parametrize("n", [1, 2, 3, 10, 45, 101])
def test_percentile_is_numpys_linear(n):
    rng = random.Random(n)
    v = [rng.uniform(0.9, 1.4) for _ in range(n)]
    for p in (0, 50, 90, 95, 100):
        assert H.percentile(v, p) == pytest.approx(np.percentile(v, p),
                                                   rel=1e-12)


def synthetic_run(times, mix=None, trace=None, extra=()):
    """Back-to-back rounds of the given lengths after a warm round, each
    split into setup, encode and frame thirds."""
    spans, t = [("round", -1, 0.0, 1.0)], 1.0
    for r, d in enumerate(times):
        spans += [("client.setup", r, t, t + d / 3),
                  ("client.encode", r, t + d / 3, t + 2 * d / 3),
                  ("client.frame", r, t + 2 * d / 3, t + d),
                  ("round", r, t, t + d)]
        t += d
    spans.append(("window", None, 1.0, t))
    spans += list(extra)
    mix = mix or {"role": "client", "clients": 1}
    config = {"d": 1000, "padded": 1024,
              "contract": {"q": 16, "bucket": 256, "rotate": True}}
    return H.Run({}, config, mix, spans, 7.5, len(times), t - 1.0, trace)


def test_round_rate_and_tail_readers():
    times = [1.0 + 0.01 * i for i in range(45)]
    run = synthetic_run(times)
    assert H.reader("client_round_s")(run) == pytest.approx(
        sum(times) / 45)
    assert H.reader("client_round_p90_s")(run) == pytest.approx(
        np.percentile(times, 90))
    assert H.reader("setup_s")(run) == 7.5
    for part in ("setup", "encode", "frame"):
        assert H.reader(f"client.{part}_s")(run) == pytest.approx(
            sum(times) / 3 / 45)


def test_round_share_of_the_chip():
    run = synthetic_run([2.0] * 4)
    want = 100 * (1000 * 4 + 1024 * 4 / 8) / 3.35e12 / 2.0
    assert H.reader("roofline_share.client")(run) == pytest.approx(want)


@pytest.mark.parametrize("uuid", ["5c1a8e6b-0d2f-4a41-9c3e-7f80b1d2e3a4",
                                  "GPU-5c1a8e6b-0d2f-4a41-9c3e-7f80b1d2e3a4"])
def test_power_limit_is_read_for_the_card_that_runs(uuid):
    table = ("GPU-0b6e3c1d-1111-2222-3333-444455556666, 700.00\n"
             "GPU-5C1A8E6B-0D2F-4A41-9C3E-7F80B1D2E3A4, 500.00\n")
    assert H.limit_of(table, uuid) == 500.0
    assert H.limit_of(table, "ffffffff-0d2f-4a41-9c3e-7f80b1d2e3a4") is None
    assert H.limit_of("GPU-5c1a8e6b-0d2f-4a41-9c3e-7f80b1d2e3a4, [N/A]",
                      uuid) is None


def test_union_and_covered():
    u = TR.union([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert u == [(0, 3), (5, 8)]
    assert TR.covered([(2, 6)], u) == 2
    assert TR.covered([(0, 10)], u) == 6


def synthetic_trace():
    ns = 10 ** 9
    host = [("window", 0, 10 * ns), ("round", 0, 10 * ns),
            ("client.setup", 0, 3 * ns), ("client.encode", 3 * ns, 6 * ns),
            ("client.frame", 6 * ns, 10 * ns)]
    device = [("void lattice_encode_kernel<4>(float const*)", 4 * ns,
               5 * ns),
              ("void fwht_kernel<float, 12>(float*)", 1 * ns, 2 * ns),
              ("Memcpy DtoH", 5 * ns, 6 * ns),
              ("late", 11 * ns, 12 * ns)]
    return TR.Trace(device, host)


def test_trace_busy_idle_and_breakdown():
    tr = synthetic_trace()
    assert tr.window_s() == 10 and tr.busy_s() == 3
    assert tr.kernel_s("lattice_encode_kernel") == (1.0, 1)
    top = dict(tr.top_ops())
    assert top == {"lattice_encode_kernel<4>": 1.0,
                   "fwht_kernel<float, 12>": 1.0, "Memcpy DtoH": 1.0}
    idle = dict(tr.idle_by_span())
    # gaps (0, 1), (2, 4), (6, 10), by the span at each one's middle
    assert idle == pytest.approx({"client.frame": 4.0, "client.encode": 2.0,
                                  "client.setup": 1.0})


def test_trace_readers():
    run = synthetic_run([10.0], trace=synthetic_trace())
    assert H.reader("idle_share.client")(run) == pytest.approx(70.0)
    enc = roofline.encode_bytes(1024, 4, 4)
    assert H.reader("lattice_encode_roofline")(run) == pytest.approx(
        100 * enc / 3.35e12)
    assert H.reader("fwht_roofline")(run) == pytest.approx(
        100 * 1024 * 8 / 3.35e12)


def test_frozen_byte_counts_give_the_smokes_bounds():
    n, nb = 277_848_064, 277_848_064 // 4096
    assert roofline.bound_ms(roofline.encode_bytes(n, 4, nb)) == \
        pytest.approx(1.0368275, abs=5e-8)
    assert roofline.bound_ms(roofline.decode_batched_bytes(16, n, 4, nb)) \
        == pytest.approx(6.6364736, abs=5e-8)
    assert roofline.bound_ms(roofline.fwht_bytes(n)) == pytest.approx(
        0.6635178, abs=5e-8)


@pytest.mark.parametrize("q,bits", [(2, 1), (3, 2), (16, 4), (17, 8),
                                    (256, 8), (65536, 16)])
def test_bits_for_q(q, bits):
    assert roofline.bits_for_q(q) == bits


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_inputs_come_from_the_seed(seed):
    a = inputs.base_vector(1000, seed, "cpu")
    assert torch.equal(a, inputs.base_vector(1000, seed, "cpu"))
    assert not torch.equal(a, inputs.base_vector(1000, seed + 1, "cpu"))
    x = inputs.client_vector(a, seed, 3, 0, 0.02)
    assert torch.equal(x, inputs.client_vector(a, seed, 3, 0, 0.02))
    assert not torch.equal(x, inputs.client_vector(a, seed, 4, 0, 0.02))
    assert float((x - a).std()) == pytest.approx(0.02, rel=0.2)
    assert inputs.priority(seed, 3) == inputs.priority(seed, 3)
    assert 0 <= inputs.spec_seed(seed) < 2**31
