"""The FWHT's share of its HBM bound: the bucketized f32 vector read once
and written once, over its profiled device time a call."""
from dme_bench import roofline


def read(run):
    return run.kernel_share("fwht", roofline.fwht_bytes(run.config["padded"]),
                            run.rounds * int(run.mix["clients"]))
