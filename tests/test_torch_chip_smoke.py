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
    dtype and head dim to, and every attention entry has a case (so each
    wide instance checked on the card names its own source)."""
    import importlib.util

    import torch

    from repro_torch.kernels.flash_attention import kernel_of

    spec = importlib.util.spec_from_file_location("chip_smoke_tables",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    seen = set()
    for _, _, _, hd, _, _, dt, _ in cs.ATTENTION_CASES:
        name = cs.attention_kernel(dt, hd)
        seen.add(name)
        src, replaces = cs.KERNEL_SOURCES[name]
        assert Path(src).stem == kernel_of(getattr(torch, dt), hd)[0], name
        assert (ROOT / src).exists()
        assert replaces == "src/repro/kernels/flash_attention.py:62"
    assert seen == {n for n in cs.KERNEL_SOURCES
                    if n.startswith("flash_attention")}
