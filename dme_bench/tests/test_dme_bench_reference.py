"""The reference client against the port on the CPU: the same frame, byte
for byte, and the frozen threefry stream against the port's draws."""
import pytest
import torch

from dme_bench.reference import client as RC
from dme_bench.reference import threefry as T


def port_frames(c: RC.Contract, seed: int, round_id: int, client_id: int,
                x: torch.Tensor):
    from repro_torch.agg.client import AggClient
    from repro_torch.agg.transport.frame import RoundSpec
    from repro_torch.dist.collectives import QSyncConfig
    spec = RoundSpec(round_id=round_id, d=c.d,
                     cfg=QSyncConfig(q=c.q, bucket=c.bucket, rotate=c.rotate),
                     y0=c.y0, seed=seed, rot_seed=c.rot_seed)
    client = AggClient(spec, client_id, x, device="cpu")
    client.encode()
    return client.frames()


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("d,bucket,q", [(3 * 4096 + 77, 4096, 16),
                                        (100, 16, 16), (1000, 64, 4),
                                        (513, 32, 256)])
def test_reference_frame_is_the_ports(rotate, d, bucket, q):
    c = RC.Contract(d=d, q=q, bucket=bucket, y0=0.25, rotate=rotate,
                    rot_seed=20210507)
    g = torch.Generator().manual_seed(d + q)
    x = torch.randn(d, generator=g) * 2
    for seed, round_id in ((1, 0), (2**31 - 1, 7), (12345, 2**32 - 1)):
        want = RC.frame(x, c, seed, round_id, 3)
        assert RC.bad_bytes(port_frames(c, seed, round_id, 3, x), want) == 0


def test_reference_blocks_split_a_vector_as_one_block(monkeypatch):
    c = RC.Contract(d=5 * 64 + 3, q=16, bucket=64, y0=0.25, rotate=True,
                    rot_seed=3)
    x = torch.randn(c.d, generator=torch.Generator().manual_seed(1))
    whole = RC.frame(x, c, 9, 4, 0)
    monkeypatch.setattr(RC, "BLOCK", 128)
    assert RC.frame(x, c, 9, 4, 0) == whole


def test_control_differs_from_the_reference():
    c = RC.Contract(d=4096, q=16, bucket=4096, y0=0.25, rotate=False,
                    rot_seed=1)
    x = torch.randn(c.d, generator=torch.Generator().manual_seed(2))
    want = RC.frame(x, c, 9, 4, 0)
    ctl = RC.ReferenceClient(c, 9, 4, 0, x, dtype=torch.bfloat16)
    assert RC.bad_bytes(ctl.frames(), want) > 100
    same = RC.ReferenceClient(c, 9, 4, 0, x, dtype=torch.float32)
    assert RC.bad_bytes(same.frames(), want) == 0


def test_bad_bytes_counts_missing_bytes():
    assert RC.bad_bytes([b"abc", b"d"], b"abcd") == 0
    assert RC.bad_bytes([b"abd"], b"abcd") == 2


@pytest.mark.parametrize("span", [(0, 10), (5, 40), (1 << 24, (1 << 24) + 9)])
def test_frozen_threefry_is_the_ports(span):
    from repro_torch import random as R
    key = R.fold_in(R.fold_in(R.PRNGKey(2**31 + 5), 77), 1)
    assert T.fold_in(T.fold_in(T.prng_key(2**31 + 5), 77), 1) == key
    n = span[1]
    assert torch.equal(T.bits(key, span, "cpu"),
                       R.bits(key, (n,), device="cpu", span=span))
    assert torch.equal(T.uniform(key, span, -0.5, 0.5, "cpu"),
                       R.uniform(key, (n,), -0.5, 0.5, device="cpu",
                                 span=span))
    assert torch.equal(T.rademacher(key, 64, "cpu"),
                       R.rademacher(key, (64,), device="cpu"))
