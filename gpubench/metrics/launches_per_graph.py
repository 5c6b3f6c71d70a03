"""Kernel launches per graph: the program's launch counters
(``ops.launch_counts``) over the window, per graph completed."""


def read(run):
    done = len(run.done)
    return sum(run.launches.values()) / done if done else None
