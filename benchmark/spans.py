"""The per-layer readers of the program's spans (`hairgs_tpu_torch/telemetry.py`).

Two sources. The window readers read the program's ring of spans over the
unprofiled window, [logger.t_open, logger.t_close] on `perf_counter`, the
spans' clock. The trace readers read the profiled stretch's torch.profiler
trace, in which the program's spans are host ranges named "hairgs::<span>"
on the trace's clock: each device operation goes to the innermost span
around its launch (the runtime call that has its correlation id); an
operation launched by a backward node goes to the innermost span around the
forward operation that made the node (the node's sequence number on its
forward thread).

Each reader returns None where it cannot read: the program keeps no spans
(no `telemetry` module), the ring dropped spans that ended in the window,
the trace holds no "hairgs::" range, or more than UNATTRIBUTED of the
device's busy time has no span."""

import bisect
import sys
from typing import NamedTuple

import numpy as np

from benchmark.trace import _union

PREFIX = "hairgs::"
UNATTRIBUTED = 0.05  # the most of the busy time a device share leaves without a span
SYNC_CALLS = frozenset((  # runtime calls that wait for the device
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyFromSymbol",
    "cudaMemcpyToSymbol"))
# a copy from pageable host memory may wait for the stream before it returns
MAY_WAIT = SYNC_CALLS | {"cudaMemcpyAsync"}
TOPOLOGY_PHASES = {  # metric: the spans it sums inside topo/event
    "merge_search": ("topo/merge_search",),
    "strand_walk": ("topo/walk", "topo/strand_tables"),
    "topology_transfer": ("topo/pull", "topo/install"),
}


# --- the ring, over the window ------------------------------------------

class Window(NamedTuple):
    spans: object  # telemetry.Spans
    lo: int  # the window's ends, perf_counter ns
    hi: int


def window(ctx):
    """The program's spans and the window's ends, or None."""
    try:
        from hairgs_tpu_torch import telemetry
    except ImportError:
        return None
    sp = telemetry.RING.snapshot()
    lo, hi = round(ctx.logger.t_open * 1e9), round(ctx.logger.t_close * 1e9)
    if sp.dropped and (len(sp.t1) == 0 or sp.t1[0] > lo):
        return None  # spans that ended in the window are gone
    return Window(sp, lo, hi)


def _clipped(w, rows):
    """Σ of the rows' spans clipped to the window, in ns."""
    sp = w.spans
    rows = np.asarray(rows, np.int64)
    return float(np.sum(np.minimum(sp.t1[rows], w.hi) - np.maximum(sp.t0[rows], w.lo)))


def _rows(w, *names):
    """The rows of the named spans that overlap the window."""
    sp = w.spans
    codes = [sp.names.index(n) for n in names if n in sp.names]
    return np.flatnonzero(np.isin(sp.code, codes) & (sp.t1 > w.lo) & (sp.t0 < w.hi))


def host_step_share(ctx):
    """Σ of the `train/step` spans in the window over the window's wall
    time, in %. A step span is the host's enqueue of the step and also
    every wait for the device inside it: a synchronising call in the step
    (`syncs_per_it`) holds the host until the card has drained the queue.
    A traced run prints the waits' share of the step spans (stderr)."""
    w = window(ctx)
    if w is None:
        return None
    rows = _rows(w, "train/step")
    if len(rows) == 0:
        return None
    return 100.0 * _clipped(w, rows) / (w.hi - w.lo)


def _inside_events(w, names):
    """The rows of the named spans inside a `topo/event` span, each taken
    once (the outermost of the named ones on its path)."""
    sp = w.spans
    code = {n: sp.names.index(n) for n in (*names, "topo/event") if n in sp.names}
    event = code.get("topo/event")
    wanted = {code[n] for n in names if n in code}
    # a span's ancestors overlap the window wherever it does
    near = _rows(w, *sp.names)
    of = dict(zip(sp.id[near].tolist(), zip(sp.parent[near].tolist(),
                                            sp.code[near].tolist())))
    rows = []
    for i in _rows(w, *names):
        parent = int(sp.parent[i])
        while parent in of and of[parent][1] not in wanted and of[parent][1] != event:
            parent = of[parent][0]
        if parent in of and of[parent][1] == event:
            rows.append(i)
    return rows


def _topology_share(ctx, phase):
    w = window(ctx)
    if w is None:
        return None
    names = TOPOLOGY_PHASES[phase]
    if not all(n in w.spans.names for n in (*names, "topo/event")):
        return None
    _report_topology(w, ctx)
    return 100.0 * _clipped(w, _inside_events(w, names)) / (w.hi - w.lo)


def merge_search_share(ctx):
    """Σ of the merge candidate searches (`topo/merge_search`) inside the
    window's topology events over the window's wall time, in %."""
    return _topology_share(ctx, "merge_search")


def strand_walk_share(ctx):
    """Σ of the strand walks (`topo/walk`) and the smoothness tables'
    rebuilds (`topo/strand_tables`) inside the window's topology events over
    the window's wall time, in %."""
    return _topology_share(ctx, "strand_walk")


def topology_transfer_share(ctx):
    """Σ of the arenas' pulls to the host (`topo/pull`) and installs back
    (`topo/install`) inside the window's topology events over the window's
    wall time, in %."""
    return _topology_share(ctx, "topology_transfer")


def densify_strategies_share(ctx):
    """Σ of densification's clone, split and prune decisions
    (`topo/strategies`) inside the window's topology events over the
    window's wall time, in %; None where no such span falls in the window."""
    w = window(ctx)
    if w is None or not all(n in w.spans.names for n in ("topo/strategies", "topo/event")):
        return None
    rows = _inside_events(w, ("topo/strategies",))
    if not rows:
        return None
    _report_topology(w, ctx)
    return 100.0 * _clipped(w, rows) / (w.hi - w.lo)


_reported = set()


def _report_topology(w, ctx):
    """Once a run: the window's events and their phases on standard error,
    beside the logger's `topology_ms`."""
    if "topology" in _reported:
        return
    _reported.add("topology")
    events = _rows(w, "topo/event")
    logged = sum(r.topology_ms for r in ctx.logger.rows if r.topology_ms is not None)
    parts = [f"topo/event {_clipped(w, events) * 1e-6:.1f} ms over {len(events)}"
             f" (topology_ms {logged:.1f})"]
    names = sorted({n for p in TOPOLOGY_PHASES.values() for n in p}
                   | {"topo/strategies", "topo/merge_apply", "train/sync"})
    for n in names:
        parts.append(f"{n} {_clipped(w, _inside_events(w, (n,))) * 1e-6:.1f}")
    print("[bench] window spans (ms): " + ", ".join(parts), file=sys.stderr)


# --- the trace, over the profiled stretch -------------------------------

class Timeline:
    """The innermost of nested labelled intervals on one thread, as a
    function of time: `label[i]` holds from `t[i]` to `t[i + 1]`."""

    def __init__(self, intervals):
        self.t, self.label = [], []
        stack = []  # (end, label) of the open intervals, innermost last

        def close(until):
            while stack and stack[-1][0] <= until:
                end = stack.pop()[0]
                while stack and stack[-1][0] <= end:  # ended under it
                    stack.pop()
                self.t.append(end)
                self.label.append(stack[-1][1] if stack else None)

        for s, e, label in sorted(intervals, key=lambda x: (x[0], -x[1])):
            close(s)
            stack.append((e, label))
            self.t.append(s)
            self.label.append(label)
        close(float("inf"))

    def at(self, t):
        i = bisect.bisect_right(self.t, t) - 1
        return self.label[i] if i >= 0 else None

    def pieces(self, a, b):
        """(label, length) of each piece of [a, b]."""
        i = bisect.bisect_right(self.t, a) - 1
        while a < b:
            end = min(self.t[i + 1] if i + 1 < len(self.t) else b, b)
            if end > a:
                yield (self.label[i] if i >= 0 else None), end - a
                a = end
            i += 1


def _length(intervals):
    return sum(e - s for s, e in intervals)


def _overlap(a, b):
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Trace(NamedTuple):
    busy: list  # the union of the device's operations, [[start, end]] ns
    by_span: dict  # span (None: no span) -> its operations' [(start, end)]
    steps: list  # the union of the `train/step` spans
    main: Timeline  # the spans of the thread that ran the steps
    syncs: dict  # span (None: no span) -> its runtime calls that waited for the device
    runtime: int  # runtime calls
    step_wait: int  # ns of those and of the copies inside the `train/step` spans


_parsed = [None, None]  # (profiler, Trace): the readers of one run share it


def trace(ctx):
    """The profiled stretch read once a run, or None without a profile or
    without the program's spans in it."""
    prof = ctx.logger.prof
    if prof is None:
        return None
    if _parsed[0] is not prof:
        _parsed[:] = [prof, _read(prof.profiler.kineto_results.events())]
    return _parsed[1]


def _read(events):
    spans, nodes = {}, {}  # thread -> [(start, end, label)]
    forward = {}  # (thread, sequence number) -> start of the forward operation
    launch = {}  # correlation id -> (thread, start) of the runtime call
    device = []  # (start, end, correlation id)
    waits = []  # (thread, start, end) of the runtime calls that waited
    copies = []  # (thread, start, end) of the ones that may have
    runtime = 0
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                device.append((start, end, e.correlation_id()))
            continue
        tid = e.start_thread_id()
        if name.startswith(PREFIX):
            spans.setdefault(tid, []).append((start, end, name[len(PREFIX):]))
        elif name.startswith("cu"):  # the CUDA runtime and driver APIs
            runtime += 1
            if name in SYNC_CALLS:
                waits.append((tid, start, end))
            if name in MAY_WAIT:
                copies.append((tid, start, end))
            launch[e.correlation_id()] = (tid, start)
        elif e.fwd_thread_id() > 0:  # a backward node
            nodes.setdefault(tid, []).append(
                (start, end, (e.fwd_thread_id(), e.sequence_nr())))
        elif e.sequence_nr() >= 0:
            forward.setdefault((tid, e.sequence_nr()), start)
    if not spans:
        return None
    span_tl = {t: Timeline(v) for t, v in spans.items()}
    node_tl = {t: Timeline(v) for t, v in nodes.items()}
    step_thread = max(spans, key=lambda t: sum(lab == "train/step" for _, _, lab in spans[t]))
    main = span_tl[step_thread]

    def span_at(tid, t):
        tl = span_tl.get(tid)
        label = tl.at(t) if tl is not None else None
        # a thread of no span of its own (autograd's device thread) works
        # while the steps' thread waits in one
        return main.at(t) if label is None and tl is None else label

    by_span = {}
    for start, end, corr in device:
        label = None
        if corr in launch:
            tid, t = launch[corr]
            node = node_tl[tid].at(t) if tid in node_tl else None
            if node is not None:
                fwd_tid, seq = node
                t_fwd = forward.get((fwd_tid, seq))
                label = (span_at(fwd_tid, t_fwd) if t_fwd is not None
                         else span_at(fwd_tid, t))
            else:
                label = span_at(tid, t)
        by_span.setdefault(label, []).append((start, end))
    syncs = {}
    for tid, t, _ in waits:
        label = span_at(tid, t)
        syncs[label] = syncs.get(label, 0) + 1
    steps = _union((s, e) for s, e, lab in spans[step_thread] if lab == "train/step")
    step_wait = _overlap(_union((s, e) for t, s, e in copies if t == step_thread), steps)
    return Trace(_union((s, e) for s, e, _ in device), by_span, steps, main, syncs,
                 runtime, step_wait)


def _device_share(ctx, span):
    tr = trace(ctx)
    if tr is None or not tr.busy:
        return None
    busy = _length(tr.busy)
    _report_trace(tr, busy)
    if _length(_union(tr.by_span.get(None, []))) > UNATTRIBUTED * busy:
        return None
    return 100.0 * _length(_union(tr.by_span.get(span, []))) / busy


def binning_device_share(ctx):
    """Device seconds of the operations that `render/binning` launched (the
    sorted binning through the gathered pair planes, forward and backward)
    over the device's busy seconds in the profiled stretch, in %."""
    return _device_share(ctx, "render/binning")


def loss_device_share(ctx):
    """Device seconds of the operations that `loss` launched (SSIM, the l1,
    mask and orientation losses, forward and backward) over the device's
    busy seconds in the profiled stretch, in %."""
    return _device_share(ctx, "loss")


def _gaps(busy):
    return [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]


def idle_outside_step(ctx):
    """The share of the device's idle time in the profiled stretch (the gaps
    between its operations) that falls outside every `train/step` span, in
    %: idle the loop between the steps leaves (syncs, topology events, the
    controllers), not the launch path."""
    tr = trace(ctx)
    if tr is None or not tr.busy or not tr.steps:
        return None
    gaps = _gaps(tr.busy)
    idle = _length(gaps)
    if idle <= 0:
        return None
    return 100.0 * (idle - _overlap(gaps, tr.steps)) / idle


def syncs_per_it(ctx):
    """Runtime calls that wait for the device (stream, device and event
    synchronisations, synchronous copies) in the profiled stretch, per
    iteration, wherever the program made them."""
    tr = trace(ctx)
    if tr is None or tr.runtime == 0:
        return None
    return sum(tr.syncs.values()) / ctx.traced_its


def _report_trace(tr, busy):
    """Once a run: the device's busy time and its idle time by innermost
    span of the steps' thread, on standard error."""
    if id(tr) in _reported:
        return
    _reported.add(id(tr))
    dev = sorted(((lab, _length(_union(v))) for lab, v in tr.by_span.items()),
                 key=lambda kv: -kv[1])
    idle = {}
    for a, b in _gaps(tr.busy):
        for lab, n in tr.main.pieces(a, b):
            idle[lab] = idle.get(lab, 0) + n
    print("[bench] device busy by span (ms): " + ", ".join(
        f"{lab} {n * 1e-6:.2f} ({100 * n / busy:.1f}%)" for lab, n in dev), file=sys.stderr)
    print("[bench] synchronising runtime calls by span: " + ", ".join(
        f"{lab} {n}" for lab, n in sorted(tr.syncs.items(), key=lambda kv: -kv[1])),
        file=sys.stderr)
    steps = _length(tr.steps)
    print(f"[bench] train/step spans {steps * 1e-6:.2f} ms, of it {tr.step_wait * 1e-6:.2f}"
          f" ms ({100 * tr.step_wait / max(steps, 1):.2f}%) in calls that wait or copy",
          file=sys.stderr)
    print("[bench] device idle by innermost span (ms): " + ", ".join(
        f"{lab} {n * 1e-6:.2f}" for lab, n in sorted(idle.items(), key=lambda kv: -kv[1])),
        file=sys.stderr)
    longest = sorted(_gaps(tr.busy), key=lambda g: g[0] - g[1])[:5]
    print("[bench] longest idle gaps (ms, innermost span at their middle): " + ", ".join(
        f"{(b - a) * 1e-6:.1f} {tr.main.at((a + b) / 2)}" for a, b in longest), file=sys.stderr)
