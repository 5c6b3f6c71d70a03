"""Reading the device's trace: what ran on the card and when.

The traced run records ``torch.profiler`` (CUPTI) over a stretch of the
window, with the benchmark's own host spans as ``record_function``
ranges named ``gpubench.<phase>``. This module reduces the trace to
numbers: the union of device intervals (``union``, the device's busy
time), device time by operation, and each idle gap named by what the
host was doing then. ``union`` is a copy of
``chip_smoke.py``'s ``union_us``. The benchmark's own check of each
graph (the ``check`` span, which starts with the device idle and ends
synchronised) is cut out of the stretch: its device work and its length
count in none of these numbers.
"""
from __future__ import annotations

import bisect
import dataclasses

SPAN_PREFIX = "gpubench."
#: Host spans whose time is the benchmark's, not the program's.
CUT = ("check",)


def union(spans) -> float:
    """The length of the union of sorted (start, end) intervals."""
    busy, cur = 0.0, None
    for start, end in spans:
        if cur is None or start > cur[1]:
            busy += (cur[1] - cur[0]) if cur else 0.0
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return busy + (cur[1] - cur[0] if cur else 0.0)


def merged(spans) -> list[tuple[float, float]]:
    """Sorted (start, end) intervals merged where they overlap."""
    out: list[list[float]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(x) for x in out]


def clipped_union(spans, lo: float, hi: float) -> float:
    """The union of ``spans`` inside [lo, hi]."""
    return union((max(s, lo), min(e, hi)) for s, e in spans
                 if e > lo and s < hi)


def idle_gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval of the merged ``busy``
    covers."""
    gaps, at = [], lo
    for start, end in busy:
        if end <= lo or start >= hi:
            continue
        if start > at:
            gaps.append((at, start))
        at = max(at, end)
    if at < hi:
        gaps.append((at, hi))
    return gaps


def phase_at(spans, t: float) -> str:
    """The innermost host span (name, start, end) that covers ``t``."""
    best = None
    for name, start, end in spans:
        if start <= t <= end and (best is None or start >= best[1]):
            best = (name, start, end)
    return best[0] if best else "between_spans"


@dataclasses.dataclass
class Trace:
    """A traced stretch, in seconds on the trace's clock."""

    start: float
    end: float
    device: list            # merged (start, end) device intervals
    ops: dict               # device seconds by operation name
    spans: list             # (phase, start, end) host spans

    def stretches(self) -> list[tuple[float, float]]:
        """The traced stretch less the benchmark's own spans."""
        cut = merged((s, e) for name, s, e in self.spans if name in CUT)
        return idle_gaps(cut, self.start, self.end)

    @property
    def window_s(self) -> float:
        return sum(hi - lo for lo, hi in self.stretches())

    @property
    def busy_s(self) -> float:
        return sum(clipped_union(self.device, lo, hi)
                   for lo, hi in self.stretches())

    def graph_spans(self) -> list[tuple[float, float]]:
        return [(s, e) for name, s, e in self.spans if name == "graph"]

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time by what
        the host was doing, each longest first."""
        idle: dict[str, float] = {}
        for lo, hi in self.stretches():
            for g0, g1 in idle_gaps(self.device, lo, hi):
                name = phase_at(self.spans, (g0 + g1) / 2)
                idle[name] = idle.get(name, 0.0) + (g1 - g0)
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def from_profile(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``; its
    stretch runs from the first ``gpubench.`` span's start to the last
    one's end."""
    from torch.autograd import DeviceType

    kernels, spans = [], []
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            # The host spans' copies on the device's timeline, and the
            # spans CUPTI marks where the launch queue was full, are not
            # device work.
            if (e.name.startswith(SPAN_PREFIX)
                    or getattr(e, "is_user_annotation", False)
                    or e.name == "Command Buffer Full"):
                continue
            kernels.append((e.name, start, end))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], start, end))
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    cut = merged((s, e) for name, s, e in spans if name in CUT)
    starts = [s for s, _ in cut]
    device, ops = [], {}
    for name, start, end in kernels:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < cut[i][1]:
            continue                     # the benchmark's own check
        device.append((start, end))
        ops[name] = ops.get(name, 0.0) + (end - start)
    return Trace(start=min(s for _, s, _ in spans),
                 end=max(e for _, _, e in spans), device=merged(device),
                 ops=ops, spans=spans)
