"""A client's round, from its gradient on the card to its frames in host
memory: the window (the first timed round's start to the end of the last
round started inside it) over the rounds in it."""


def read(run):
    return run.window_s / run.rounds
