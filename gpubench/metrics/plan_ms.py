"""The front door's plan: mean host time of ``api.plan`` per graph, in
ms (the benchmark's span around the call)."""


def read(run):
    times = [g.plan_s for g in run.done]
    return 1e3 * sum(times) / len(times) if times else None
