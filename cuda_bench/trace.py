"""What the traced run records: host spans around the calls into each
layer, counters, and the device's operations from torch.profiler.

Spans come from wrappers the traced run installs around the program's
methods (``program.traced_methods``) and the benchmark's own finalize
loop; the program is not edited. Their clock is ``time.time_ns()``, the
clock torch.profiler stamps its events with, so that an idle gap on the
device can be named by the span open on the host. Work is summed after
the window from what the wrappers counted.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import sys
import time


class Spans:
    """Host spans [(name, start_ns, end_ns)] (outermost only) and the
    backtrace steps of the traces the finalize was handed."""

    def __init__(self):
        self.spans: list = []
        self.steps = 0
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name):
        self._depth += 1
        t0 = time.time_ns()
        try:
            yield
        finally:
            self._depth -= 1
            if self._depth == 0:
                self.spans.append((name, t0, time.time_ns()))

    def wrap(self, fn, name, counts_trace):
        @functools.wraps(fn)
        def call(*a, **k):
            if counts_trace:
                self.steps += len(a[1])  # (self, trace, ...)
            with self.span(name):
                return fn(*a, **k)
        return call

    @contextlib.contextmanager
    def installed(self, methods):
        saved = []
        for owner, attr, name, counts in methods:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, self.wrap(fn, name, counts))
        try:
            yield self
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)

    def seconds(self, prefix) -> float:
        """Seconds in the spans named ``prefix`` or ``prefix.*``."""
        return sum(e - s for n, s, e in self.spans
                   if n == prefix or n.startswith(prefix + ".")) / 1e9

    def at(self, t_ns) -> str:
        """The span open at ``t_ns``, or "other"."""
        if not hasattr(self, "_starts"):
            self.spans.sort(key=lambda x: x[1])
            self._starts = [s for _, s, _ in self.spans]
        i = bisect.bisect_right(self._starts, t_ns) - 1
        if i >= 0 and self.spans[i][2] >= t_ns:
            return self.spans[i][0]
        return "other"


def device_events(prof):
    """[(name, start_ns, end_ns)] of every operation that ran on the card
    (kernels, copies, memsets) in a torch.profiler run."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        return [(e.name(), e.start_ns(), e.end_ns()) for e in results.events()
                if e.device_type() == cuda]
    out = []
    for e in prof.events():
        if e.device_type == cuda:
            s = int(e.time_range.start * 1000)
            out.append((e.name, s, int(e.time_range.end * 1000)))
    return out


def busy_intervals(events):
    """The union of the events' intervals, sorted."""
    merged = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def idle_gaps(merged, t0_ns, t1_ns):
    """[(start_ns, end_ns)] in [t0_ns, t1_ns] when nothing ran on the card."""
    gaps = []
    t = t0_ns
    for s, e in merged:
        if s > t:
            gaps.append((t, min(s, t1_ns)))
        t = max(t, e)
        if t >= t1_ns:
            break
    if t < t1_ns:
        gaps.append((t, t1_ns))
    return [(s, e) for s, e in gaps if e > s]


class Record:
    """Everything one traced call left: its window on the host clock, the
    device's operations, the spans and counters, the work of its reads."""

    def __init__(self, t0_ns, t1_ns, events, spans, launches, cells):
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.events = events
        self.spans = spans
        self.launches = launches
        self.cells = cells
        self.steps = spans.steps
        self.int32_rate = 0.0  # the card's, read once the window has closed
        inside = [ev for ev in events if ev[2] > t0_ns and ev[1] < t1_ns]
        # the profiler's clock should be the host's: warn where it is not
        self.aligned = len(inside) >= 0.9 * len(events)
        if events and not self.aligned:
            print(f"trace: {len(events) - len(inside)} of {len(events)} "
                  "device events lie outside the traced window; idle gaps "
                  "are not named", file=sys.stderr)
        self.merged = busy_intervals(events)
        self.busy_s = sum(e - s for s, e in self.merged) / 1e9

    def device_seconds(self, match) -> tuple:
        """(count, seconds) of the device operations whose name holds any
        of the strings in ``match``."""
        ev = [e for e in self.events if any(m in e[0] for m in match)]
        return len(ev), sum(e[2] - e[1] for e in ev) / 1e9

    def breakdown(self) -> dict:
        by_op: dict = {}
        for name, s, e in self.events:
            by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e9
        ops = sorted(by_op.items(), key=lambda x: -x[1])[:10]
        by_span: dict = {}
        for s, e in idle_gaps(self.merged, self.t0_ns, self.t1_ns):
            name = self.spans.at((s + e) // 2) if self.aligned else "unaligned"
            by_span[name] = by_span.get(name, 0.0) + (e - s) / 1e9
        gaps = sorted(by_span.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps]}
