"""The port's tracer: host spans and counters of one process, off by default.

    from graphaligner_tpu_torch.utils import trace

    trace.enable()
    trace.reset()
    ...                    # set up an aligner, align reads
    snap = trace.snapshot()
    trace.disable()

``snapshot()`` returns ``{"spans": [(name, parent, start_ns, end_ns)],
"counters": {name: number}}``. A span's ``parent`` is the index in that
list of the span open around it when it opened, -1 for none; each
``align_reads_seeded_batch`` call opens a root span ``align``, so its index
identifies the call. Times are ``time.time_ns()``, the clock torch.profiler
stamps device events with: an idle gap of the card can be put down to the
span the host had open. A span still open has ``end_ns`` None.

While tracing is off, ``span`` returns one shared no-op context manager
(no allocation, no clock, no device op, no synchronize) and ``count`` and
``peak`` return at once. While it is on, a ``count`` or ``peak`` given a
tensor accumulates on the tensor's device and is read once, by
``snapshot``. The kernels' launch counters, ``batch_align.rewind_count()``
and ``host_fallback_count()`` stay always on; ``snapshot`` reports their
deltas since ``reset()`` under the names of ``ALWAYS_ON``.

The spans and counters the port records are ``SPANS`` and ``COUNTERS``.
The tracer keeps one stack for the process: trace one thread.
"""

from __future__ import annotations

import importlib
import time

import torch

# span name -> what it holds
SPANS = {
    "setup.tables": "BandedBatchAligner: the graph's host tables",
    "setup.reverse_pos": "BandedBatchAligner: the reverse-strand positions",
    "setup.reach": "BandedBatchAligner: the reach table",
    "setup.device_tables": "BandedBatchAligner: the tables' device copies",
    "align": "one align_reads_seeded_batch call (root)",
    "align.wave": "a wave's seeds and extension problems",
    "align.chunks": "the extension problems packed into chunks",
    "scan.pack": "read codes, lane packing, a round's host tables",
    "scan.carry": "a round's rewind carries: the gather and its fetch",
    "scan.upload": "a round's inputs to the device",
    "scan.issue": "a round's slice loop of launches (no sync)",
    "fetch": "a read of round outputs to the host (waits for the device)",
    "scan.unpack": "control words, and each request's run of slices",
    "scan.replay": "the host control replay (HMM, ramp rewinds)",
    "walk.tail": "removeWronglyAlignedEnd",
    "walk.gather": "the walk lanes' final slices (long mode: segments)",
    "walk.starts": "the walk starts, tie starts included",
    "walk.consolidate": "a K2 call's tables gathered from the rounds",
    "walk.recompute": "long mode: a round's columns computed again",
    "walk.issue": "K2's inputs and launch",
    "walk.decode": "K2's moves fetched and decoded, the lanes' results",
    "finalize.entry": "a wave entry assembled around its pieces",
    "finalize.read": "the tail of one read's alignment",
    "finalize.gam": "one read's id mapping and GAM encode",
}

# counter name -> what it counts
COUNTERS = {
    "scan.chunks": "chunks of extension problems",
    "scan.rounds": "scan rounds",
    "scan.slices": "slices a round scans (S_max), summed: a fused K1 "
                   "launch a slice and shard",
    "scan.lane_slices": "slices requested of the rounds' lanes",
    "scan.lane_slices_launched": "S_max x B, summed over rounds",
    "scan.band_nodes": "band nodes of the active lane-slices (device)",
    "scan.band_nodes_max": "the most band nodes of one lane-slice (device)",
    "scan.bulk_lanes": "lanes the vectorized replay finished",
    "scan.literal_lanes": "lanes the literal replay advanced a slice or more",
    "walk.accepted_runs": "runs of the walked lanes' tables, summed: one a "
                          "lane where each table is one straight stretch",
    "finalize.reads": "reads encoded to GAM",
    "long.lanes": "long mode: lanes walked",
    "long.lane_windows": "long mode: lane-windows walked",
    "long.k1_rounds": "long mode: K1 launches in the scan rounds",
    "long.k1_recompute": "long mode: K1 launches in the walk's recomputes",
    "long.k2": "long mode: K2 launches",
    "long.peak_scan_bytes": "long mode: allocator peak as the rounds end",
    "long.peak_walk_bytes": "long mode: allocator peak as the walk ends",
    "long.recompute_s": "long mode: device seconds of the recomputes",
    "long.k2_windows_s": "long mode: device seconds of the K2 windows",
}

# snapshot name -> (module, attribute) of the always-on counters
ALWAYS_ON = {
    "k1.launches": ("ops.banded_cell", "LAUNCHES"),
    "k1.launches_wide": ("ops.banded_cell", "LAUNCHES_WIDE"),
    "project_band.launches": ("ops.project_band", "LAUNCHES"),
    "k2.launches": ("ops.walk_moves", "LAUNCHES"),
    "k2.launches_wide": ("ops.walk_moves", "LAUNCHES_WIDE"),
    "k3.launches_wavefront": ("ops.exhaustive", "LAUNCHES_WAVEFRONT"),
    "k3.launches_serial": ("ops.exhaustive", "LAUNCHES_SERIAL"),
    "scan.rewinds": ("core.batch_align", "_REWIND_COUNT"),
    "host_fallbacks": ("core.batch_align", "_HOST_FALLBACKS"),
}

_on = False
_spans: list = []  # [name, parent, start_ns, end_ns]
_stack: list = []  # indices of the open spans
_counts: dict = {}  # name -> number
_device: dict = {}  # (name, device) -> (tensor, is a peak)
_base: dict = {}  # ALWAYS_ON values at reset()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "sync")

    def __init__(self, name, sync):
        self.rec = [name, -1, 0, None]
        self.sync = sync

    def __enter__(self):
        self.rec[1] = _stack[-1] if _stack else -1
        _stack.append(len(_spans))
        _spans.append(self.rec)
        self.rec[2] = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and self.sync.type == "cuda":
            torch.cuda.synchronize(self.sync)
        self.rec[3] = time.time_ns()
        _stack.pop()
        return False


def on() -> bool:
    """Is tracing on? Sites that would issue device work only to be
    counted ask first."""
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def _always_on() -> dict:
    out = {}
    for name, (mod, attr) in ALWAYS_ON.items():
        out[name] = getattr(
            importlib.import_module(f"graphaligner_tpu_torch.{mod}"), attr)
    return out


def reset() -> None:
    """Drop every span and counter; the always-on counters count from
    here."""
    _spans.clear()
    _stack.clear()
    _counts.clear()
    _device.clear()
    _base.clear()
    _base.update(_always_on())


def span(name: str, sync=None):
    """A context manager that records ``name`` while tracing is on. With
    ``sync`` a CUDA device, the span closes after synchronizing it, so
    that the device work issued inside counts."""
    if not _on:
        return _NOOP
    return _Span(name, sync)


def count(name: str, n=1) -> None:
    """Add ``n`` (a number, or a tensor summed on its device) to counter
    ``name``."""
    if not _on:
        return
    if not isinstance(n, torch.Tensor):
        _counts[name] = _counts.get(name, 0) + n
        return
    key = (name, n.device)
    acc = _device.get(key)
    n = n.sum().to(_wide(n))
    _device[key] = (n if acc is None else acc[0] + n, False)


def peak(name: str, value) -> None:
    """Keep the largest ``value`` (a number, or a tensor's maximum on its
    device) given to counter ``name``."""
    if not _on:
        return
    if not isinstance(value, torch.Tensor):
        _counts[name] = max(_counts.get(name, value), value)
        return
    key = (name, value.device)
    acc = _device.get(key)
    value = value.max().to(_wide(value))
    _device[key] = (value if acc is None else torch.maximum(acc[0], value),
                    True)


def _wide(t):
    return torch.float64 if t.is_floating_point() else torch.int64


def snapshot() -> dict:
    """The spans and counters recorded since ``reset()`` (device counters
    read here), with the always-on counters' deltas."""
    counters = {k: v.item() if hasattr(v, "item") else v
                for k, v in _counts.items()}
    for (name, _), (t, is_peak) in _device.items():
        v = t.item()
        if name not in counters:
            counters[name] = v
        else:
            counters[name] = max(counters[name], v) if is_peak \
                else counters[name] + v
    now = _always_on()
    for name, v in now.items():
        counters[name] = v - _base.get(name, 0)
    return {"spans": [tuple(s) for s in _spans], "counters": counters}


def seconds(snap: dict, *names: str, inside: str | None = None) -> float:
    """Seconds of the union of the closed spans named ``names`` (a name
    ending in "." matches every span it starts), with ``inside`` only
    those with an ancestor of that name."""
    spans = snap["spans"]

    def hit(name):
        return any(name == n or (n.endswith(".") and name.startswith(n))
                   for n in names)

    def under(i):
        p = spans[i][1]
        while p >= 0:
            if spans[p][0] == inside:
                return True
            p = spans[p][1]
        return False

    iv = sorted((s, e) for i, (n, _, s, e) in enumerate(spans)
                if e is not None and hit(n) and (inside is None or under(i)))
    total, hi = 0, None
    for s, e in iv:
        if hi is None or s > hi:
            total += e - s
            hi = e
        elif e > hi:
            total += e - hi
            hi = e
    return total / 1e9
