"""Edges of every graph completed in the window over the window's whole
wall time (host clock, barrier to barrier on more than one chip)."""


def read(run):
    edges = sum(g.emitted for g in run.done)
    return edges / run.window_s if edges else None
