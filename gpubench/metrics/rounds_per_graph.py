"""Exchange rounds per graph, as the program's ``GenStats`` counts them
(a count that repeats exactly for one seed). Reads nothing where no graph
exchanged."""


def read(run):
    rounds = [g.rounds for g in run.done]
    return sum(rounds) / len(rounds) if any(rounds) else None
