"""A round's frames() after the encode: the body's bytes, its CRCs, the
header (host only)."""


def read(run):
    return run.per_round("client.frame")
