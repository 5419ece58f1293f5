"""The whole client round's share of the chip: the least bytes a round
must move (the gradient read once, the packed words written once) at the
HBM's rate, over the round's time."""
from dme_bench import roofline


def read(run):
    c = run.config["contract"]
    bits = roofline.bits_for_q(c["q"])
    nbytes = roofline.client_round_bytes(run.config["d"],
                                         run.config["padded"], bits)
    per_round = run.window_s / run.rounds / int(run.mix["clients"])
    return 100.0 * roofline.bound_ms(nbytes) / 1e3 / per_round
