"""Reading a torch.profiler trace of the traced stretch: the device's busy
time (the union of its kernel, copy and set intervals), the operations it
ran, the device operations that took most time, and the longest gaps in
which the device was idle, each named by the host operation that overlaps
it most."""

from collections import defaultdict
from typing import NamedTuple


class Trace(NamedTuple):
    busy_s: float
    launches: int  # device operations: kernels, copies, sets
    device_ops: list  # [[name, seconds], ...] largest first
    idle_gaps: list  # [[host operation, seconds], ...] longest first


def _events(prof):
    """(device intervals [(start_ns, end_ns, name)], host intervals)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            dev.append((start, end, e.name()))
        else:
            host.append((start, end, e.name()))
    return dev, host


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_label(span, host):
    """The host operation that overlaps the span most (the shortest on a
    tie)."""
    s, e = span
    best = max(host, default=None,
               key=lambda h: (min(e, h[1]) - max(s, h[0]), h[0] - h[1]))
    return best[2] if best else "no host operation"


def read(prof, top: int = 10) -> Trace:
    dev, host = _events(prof)
    if not dev:
        return Trace(0.0, 0, [], [])
    busy = _union([(s, e) for s, e, _ in dev])
    busy_ns = sum(e - s for s, e in busy)
    per_name = defaultdict(int)
    for s, e, name in dev:
        per_name[name] += e - s
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], (busy[i][1], busy[i + 1][0]))
                   for i in range(len(busy) - 1)), reverse=True)[:top]
    host_sorted = sorted(host)
    idle = []
    for length, span in gaps:
        near = [h for h in host_sorted if h[0] < span[1] and h[1] > span[0]]
        idle.append([_host_label(span, near), length * 1e-9])
    return Trace(busy_ns * 1e-9, len(dev), [[n, t * 1e-9] for n, t in ops], idle)
