"""A round's AggClient construction: bucketize, rotation, dither draw."""


def read(run):
    return run.per_round("client.setup")
