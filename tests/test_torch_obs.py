"""repro_torch.obs spans and counters inside a client's round, on the CPU.

``obs.span`` marks the work of a round where it happens: the draws
(``draw.dither``, ``draw.weights``, ``draw.rotation``), the checksum and
the copy of the words to the host (``client.checksum``, ``client.d2h``),
and the framing's CRC passes and copies (``frame.crc``, ``frame.copy``),
with the ``frame_*_bytes`` counters beside them.  Off, a site is one
boolean check and records nothing; on, every span nests under the
innermost open one, carries the round (and client) id, and opens a
``repro:<name>`` profiler range.  Tracing never changes a frame's byte.
"""
import dataclasses
import struct
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from repro_torch.agg.client import AggClient
from repro_torch.agg.transport import frame as wire
from repro_torch.core import lattice as L
from repro_torch.core import wire_accounting as WA
from repro_torch.dist.collectives import QSyncConfig

BUCKET = 256
D = 3 * BUCKET + 77
CLIENT_SPANS = {"draw.dither", "draw.weights", "client.checksum",
                "client.d2h", "frame.crc", "frame.copy"}
FRAME_COUNTERS = ("frame_body_bytes", "frame_crc_bytes", "frame_copy_bytes")


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with observability off and empty."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _spec(rotate: bool, mtu: int = 0, round_id: int = 9):
    return wire.RoundSpec(round_id=round_id, d=D,
                          cfg=QSyncConfig(q=16, bucket=BUCKET, rotate=rotate),
                          y0=0.5, seed=3, mtu=mtu)


def _round(spec, client_id: int = 2) -> "list[bytes]":
    """One client's round as a client process drives it: the vector in,
    ``encode()``, then ``frames()``."""
    x = torch.from_numpy(np.random.RandomState(client_id).randn(D)
                         .astype(np.float32))
    client = AggClient(spec, client_id, x, device="cpu")
    client.encode()
    return client.frames()


def _on():
    obs.enable(metrics=True, trace=True, record=False,
               clock=time.perf_counter)


def _expected_spans(rotate: bool) -> "set[str]":
    return CLIENT_SPANS | ({"draw.rotation"} if rotate else set())


def _program_spans():
    """The tracer's spans that ``obs.span`` made (the key-addressed
    ``encode`` span of ``frames()`` and its ``round`` parent aside)."""
    return [s for s in obs.tracer().spans
            if s.name not in ("encode", "round")]


def _counts(spec, frames) -> "dict[str, int]":
    """The framing counters worked out from the contract and the frames:
    the body copied by ``tobytes()`` and the concatenation, hashed by
    ``build_payload`` and ``chunk_frames``, and each frame's header and
    chunk hashed and the frame copied out (with the chunk's slice, where
    the round is chunked)."""
    body = 4 * L.packed_len(spec.padded, L.bits_for_q(spec.cfg.q)) \
        + 4 * spec.nb
    nc, head = len(frames), wire._HEADER.size
    assert sum(len(f) for f in frames) == body + nc * (head + 4)
    return {"frame_body_bytes": body,
            "frame_crc_bytes": 3 * body + nc * head,
            "frame_copy_bytes": 2 * body + sum(len(f) for f in frames)
            + (body if nc > 1 else 0)}


@pytest.mark.parametrize("rotate", [False, True])
def test_off_records_nothing_and_spans_are_the_null_context(rotate,
                                                            monkeypatch):
    def never(*a, **k):
        raise AssertionError("a span site did more than check the switch")
    monkeypatch.setattr(obs, "_ProgramSpan", never)
    monkeypatch.setattr(torch.profiler, "record_function", never)
    null = obs.span("frame.crc", round=1, client=2)
    assert obs.span("draw.dither") is null
    assert null is obs._NULL_SPAN
    before = {i.name for i in obs.registry().instruments()}
    _round(_spec(rotate))
    assert obs.tracer().spans == []
    after = {i.name for i in obs.registry().instruments()}
    assert after == before and not after & set(FRAME_COUNTERS)


@pytest.mark.parametrize("rotate", [False, True])
def test_on_records_every_span_nested_and_tagged(rotate):
    spec = _spec(rotate)
    _on()
    _round(spec, client_id=2)
    spans = _program_spans()
    names = [s.name for s in spans]
    assert set(names) == _expected_spans(rotate)
    # build_payload, chunk_frames and encode_frames hash the body; only
    # build_payload and encode_frames copy it
    assert names.count("frame.crc") == 3 and names.count("frame.copy") == 2
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.end is not None and s.end >= s.start
        assert s.attrs["round"] == spec.round_id
        if not s.name.startswith("draw."):
            assert s.attrs["client"] == 2
        parent = by_id.get(s.parent_id)
        if s.name == "draw.weights":
            # drawn inside the checksum's statement: a child of it
            assert parent is not None and parent.name == "client.checksum"
            assert parent.start <= s.start and s.end <= parent.end
        else:
            assert s.parent_id is None
    assert not obs.tracer()._stack()


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("mtu", [0, 128])
def test_counters_equal_the_contracts_counts(rotate, mtu):
    spec = _spec(rotate, mtu)
    _on()
    frames = _round(spec)
    assert len(frames) == WA.n_chunks(spec.body_bytes(), mtu)
    assert (len(frames) > 1) == (mtu > 0)
    got = {n: obs.registry().value(n) for n in FRAME_COUNTERS}
    assert got == _counts(spec, frames)
    # a chunked round adds counts, not spans
    names = [s.name for s in _program_spans()]
    assert names.count("frame.crc") == 3 and names.count("frame.copy") == 2


@pytest.mark.parametrize("rotate", [False, True])
def test_spans_are_profiler_ranges(rotate):
    _on()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _round(_spec(rotate))
    ranges = sorted(e.name() for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(obs.PREFIX))
    assert ranges == sorted(obs.PREFIX + s.name for s in _program_spans())
    assert {r.removeprefix(obs.PREFIX) for r in ranges} == \
        _expected_spans(rotate)


def _frames_of_one_frame_per_chunk(spec, frames) -> "list[bytes]":
    """The chunk sequence framed one chunk at a time: header, CRC-32 over
    header and chunk, chunk."""
    h0, body = wire.decode_frame(frames[0])[0], b"".join(
        wire.decode_frame(f)[1] for f in frames)
    nc = WA.n_chunks(len(body), spec.mtu)
    out = []
    for i in range(nc):
        off, ln = WA.chunk_span(len(body), spec.mtu, i)
        head = wire._pack_header(dataclasses.replace(
            h0, n_chunks=nc, chunk_index=i, payload_crc=zlib.crc32(body)))
        chunk = body[off:off + ln]
        crc = zlib.crc32(chunk, zlib.crc32(head))
        out.append(head + struct.pack("<I", crc) + chunk)
    return out


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("mtu", [0, 128])
def test_frames_are_byte_identical_with_tracing_on_and_off(rotate, mtu):
    spec = _spec(rotate, mtu)
    off = _round(spec)
    _on()
    on = _round(spec)
    assert on == off
    assert off == _frames_of_one_frame_per_chunk(spec, off)
    payload = wire.payload_from_body(
        wire.decode_frame(off[0])[0],
        b"".join(wire.decode_frame(f)[1] for f in off))
    assert payload.round_id == spec.round_id and payload.client_id == 2


def test_span_stack_is_per_thread():
    _on()
    seen = {}

    def work(tag):
        with obs.span("outer", round=tag):
            time.sleep(0.01)
            with obs.span("inner", round=tag):
                time.sleep(0.01)
        seen[tag] = True

    threads = [threading.Thread(target=work, args=(t,)) for t in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads) and len(seen) == 2
    by_id = {s.span_id: s for s in obs.tracer().spans}
    for s in obs.tracer().spans:
        if s.name == "inner":
            parent = by_id[s.parent_id]
            assert parent.name == "outer"
            assert parent.attrs["round"] == s.attrs["round"]
        else:
            assert s.parent_id is None


def test_reset_inside_an_open_span_leaves_the_stack_sound():
    _on()
    with obs.span("outer", round=1):
        obs.reset()
    with obs.span("after", round=2):
        pass
    (s,) = obs.tracer().spans
    assert s.name == "after" and s.parent_id is None
