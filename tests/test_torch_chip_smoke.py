"""``chip_smoke.py`` leaves no process behind (CPU).

The smoke spawns ranks, and a rank may start processes of its own; when
the smoke ends, ``stop_children`` must have stopped every one of them,
multiprocessing's resource tracker included, and a grandchild whose
parent exited first too.  Run in a subprocess: ``adopt_orphans`` makes
its caller the reaper of its descendants for good.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = r"""
import json, multiprocessing as mp, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as CS

CS.adopt_orphans()
q = mp.get_context("spawn").Queue()      # starts the resource tracker
# a child that starts a process and exits before it
subprocess.run([sys.executable, "-c",
                "import subprocess, sys; subprocess.Popen([sys.executable, "
                "'-c', 'import time; time.sleep(600)'], "
                "start_new_session=True)"], check=True)
deadline = time.monotonic() + 30
while len(CS._children()) < 2 and time.monotonic() < deadline:
    time.sleep(0.05)                     # the orphan comes to this process
before = CS._children()
stopped = CS.stop_children(grace_s=5.0)
print(json.dumps(dict(before=list(before.values()), stopped=stopped,
                      after=list(CS._children().values()))))
"""


def test_stop_children_leaves_no_process():
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-4000:]
    import json
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the resource tracker and the orphaned sleeper were children
    assert any("resource_tracker" in c for c in got["before"]), got
    assert any("time.sleep(600)" in c for c in got["before"]), got
    assert any("time.sleep(600)" in c for c in got["stopped"]), got
    assert got["after"] == [], got


def test_attention_cases_match_the_kernels_line():
    """Every attention case of the smoke has its entry in the ``kernels``
    line, whose source is the library that ``kernel_of`` routes the case's
    dtype, head dim, query rows and causal flags to, and every attention
    entry has a case (so each wide and split instance checked on the card
    names its own source)."""
    import importlib.util

    import torch

    from repro_torch.kernels.flash_attention import kernel_of

    spec = importlib.util.spec_from_file_location("chip_smoke_tables",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    seen = set()
    for _, _, _, hd, tokens, _, dt, causals in cs.ATTENTION_CASES:
        name = cs.attention_kernel(dt, hd, tokens, causals)
        seen.add(name)
        src, replaces = cs.KERNEL_SOURCES[name]
        sq = tokens[0] if isinstance(tokens, tuple) else tokens
        for causal in causals:
            assert Path(src).stem == kernel_of(getattr(torch, dt), hd, sq,
                                               causal)[0], name
        assert (ROOT / src).exists()
        assert replaces == "src/repro/kernels/flash_attention.py:62"
    assert seen == {n for n in cs.KERNEL_SOURCES
                    if n.startswith("flash_attention")}


@pytest.mark.parametrize("d", [1, 2, 64, 8192])
def test_hadamard_is_the_plain_fwht_of_the_identity(d):
    """The smoke's FWHT yardstick multiplies by ``hadamard(d)``, a
    Kronecker power: bit for bit the plain FWHT of the identity, so the
    product computes the FWHT."""
    import importlib.util

    import torch

    from repro_torch.kernels import ref

    spec = importlib.util.spec_from_file_location("chip_smoke_tables",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    h = cs.hadamard(torch, d, torch.device("cpu"))
    assert torch.equal(h, ref.fwht_ref(torch.eye(d)))
