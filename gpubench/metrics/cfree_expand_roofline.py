"""The R-MAT graph's share of its roofline, in %: the least time the
card could make the graph in, the larger of its integer operations over
the peak integer rate and its bytes over the peak memory bandwidth (both
from the spec: ``gpubench/work.py``), over the device's busy time per
graph (the union of the device's intervals inside each traced graph's
span, averaged). It reads the same work whatever kernel implements it;
at most 100 by construction of the bound."""
from gpubench import trace as trace_lib
from gpubench import work


def read(run):
    graph = run.config["graph"]
    if run.trace is None or graph.get("model") != "rmat" or not run.peaks:
        return None
    spans = run.trace.graph_spans()
    busy = [trace_lib.clipped_union(run.trace.device, s, e)
            for s, e in spans]
    busy = [b for b in busy if b > 0]
    if not busy:
        return None
    bound, _ = work.bound_s(*work.rmat(graph), run.peaks)
    return 100.0 * bound / (sum(busy) / len(busy))
