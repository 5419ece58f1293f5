"""A round's encode(): the encode kernel, the checksum-weights draw, the
checksum and the copy of the words to the host."""


def read(run):
    return run.per_round("client.encode")
