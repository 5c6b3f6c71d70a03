"""Process start to the first timed graph: imports, the card, the
kernels' build or load, and one warm-up graph of the cell's shape."""


def read(run):
    return run.setup_s
