"""On the card: the cells at a few thousand buckets through the port's
kernels read correct, and the control reads not correct."""
import pytest

CELLS = ["whisper-small.client", "granite-moe-1b-a400m.client_rot"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    import time

    from dme_bench import harness as H
    m = H.load_manifest()
    c, config, mix = H.resolve(m, cell)
    d = 2000 * 4096 + 123
    config = dict(config, d=d, padded=2001 * 4096)
    for control in (False, True):
        r = H.run_cell(c, config, mix, m["per_layer"], seed=2**31 + 3,
                       seconds=1.0, trace=True, device=card,
                       t_start=time.perf_counter(), control=control)
        assert r["correct"] != control, r["checks"]
        if not control:
            assert 0 < r["metrics"]["lattice_encode_roofline"]["value"] <= 105
