"""The stream's set-up (phase 1 and exchange 1, the stream object's
construction): mean seconds per graph of the benchmark's span around it,
synchronised at both ends. Reads nothing where no stream was made."""


def read(run):
    times = run.spans.get("stream_setup", [])
    return sum(times) / len(times) if times else None
