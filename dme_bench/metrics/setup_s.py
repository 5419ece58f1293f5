"""Set-up: from the process's start to the first timed round (imports,
the kernels built or loaded, the vectors made on the card, a warm round)."""


def read(run):
    return run.setup_s
