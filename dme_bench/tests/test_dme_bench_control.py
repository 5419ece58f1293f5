"""A whole run of each cell on the CPU at a few buckets: the program reads
correct; the control in its place, and each fault planted underneath the
timed path, read not correct."""
import pytest

CELLS = ["whisper-small.client", "granite-moe-1b-a400m.client_rot"]
# long enough for the rounds the check samples on a loaded CPU; a run that
# must read not correct does so from its first round
WINDOW_S = 3.0


@pytest.mark.parametrize("cell", CELLS)
def test_program_reads_correct(tiny, cell):
    r = tiny(cell, seconds=WINDOW_S)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 3
    assert set(r["metrics"]) >= {"setup_s", "client_round_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["bad_bytes"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_correct(tiny, cell):
    r = tiny(cell, trace=True, seconds=WINDOW_S)
    assert r["correct"]
    assert {"client.setup_s", "client.encode_s", "client.frame_s"} <= \
        set(r["metrics"])
    # no device in a CPU run: the device's readers find nothing to read
    assert "idle_share.client" not in r["metrics"]
    assert r["device"]["busy_s"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(tiny, cell):
    r = tiny(cell, control=True)
    assert not r["correct"] and r["checks"]["bad_bytes"]["value"] > 0


def stale_state(monkeypatch):
    """Every client sends the first frames any client made."""
    from repro_torch.agg.client import AggClient
    frames, first = AggClient.frames, []

    def stale(self, attempt=None):
        if not first:
            first.append(frames(self, attempt))
        return list(first[0])
    monkeypatch.setattr(AggClient, "frames", stale)


def half_left_out(monkeypatch):
    """The encode sees the first half of the coordinates; the rest are
    left as zeros."""
    from repro_torch.kernels import ops
    encode = ops.lattice_encode

    def half(x, u, s, **kw):
        x = x.clone()
        x[x.shape[0] // 2:] = 0
        return encode(x, u, s, **kw)
    monkeypatch.setattr(ops, "lattice_encode", half)


def answer_altered(monkeypatch):
    """One packed word flips a bit where the encode produces it."""
    from repro_torch.kernels import ops
    encode = ops.lattice_encode

    def flipped(*args, **kw):
        out = encode(*args, **kw)
        words = out[0] if isinstance(out, tuple) else out
        words[words.shape[0] // 3] ^= 1 << 5
        return out
    monkeypatch.setattr(ops, "lattice_encode", flipped)


@pytest.mark.parametrize("fault", [stale_state, half_left_out,
                                   answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_reads_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = tiny(cell)
    assert not r["correct"] and r["checks"]["bad_bytes"]["value"] > 0


def test_a_round_that_raises_counts_as_failed(tiny, monkeypatch):
    from repro_torch.agg.client import AggClient
    frames, calls = AggClient.frames, []

    def flaky(self, attempt=None):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("planted")
        return frames(self, attempt)
    monkeypatch.setattr(AggClient, "frames", flaky)
    r = tiny(CELLS[0], seconds=WINDOW_S)
    assert r["failed"] == 1 and not r["correct"]
    assert r["checks"]["failed_rounds"] == {"value": 1, "limit": 0}
    assert r["checks"]["bad_bytes"]["value"] == 0
