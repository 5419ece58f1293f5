"""The encode kernel's share of its HBM bound: x and u read, the int32
coordinates and the packed words written, the sides read, once each, over
its profiled device time a call."""
from dme_bench import roofline


def read(run):
    c = run.config["contract"]
    padded = run.config["padded"]
    bits = roofline.bits_for_q(c["q"])
    nbytes = roofline.encode_bytes(padded, bits, padded // c["bucket"])
    return run.kernel_share("lattice_encode_kernel", nbytes,
                            run.rounds * int(run.mix["clients"]))
