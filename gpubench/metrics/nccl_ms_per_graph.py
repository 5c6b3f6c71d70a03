"""Rank 0's device time in NCCL kernels per traced graph, in ms, by the
kernels' own names in the device trace. Reads nothing where no NCCL
kernel ran."""


def read(run):
    if run.trace is None or not run.trace.graph_spans():
        return None
    nccl = sum(s for name, s in run.trace.ops.items()
               if "nccl" in name.lower())
    return 1e3 * nccl / len(run.trace.graph_spans()) if nccl else None
