"""The 90th percentile of the window's client rounds: the straggler that a
round's quorum waits for."""
from dme_bench.harness import percentile


def read(run):
    return percentile(run.round_times(), 90)
