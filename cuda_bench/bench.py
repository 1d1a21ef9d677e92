"""The harness: one run of one cell.

Set-up (``setup_s`` counts all of it, from the first line of run.py):
CUDA init; the program's extensions; the configuration's graph from the
seed, loaded by the program; one ``BandedBatchAligner`` (its graph
tables, reach table and device tables); a pool of distinct reads from the
seed; one warm-up call on reads outside the pool. The window: calls of
the configuration's ``device_batch`` reads, back to back, until
``--seconds`` have passed; the call running at the deadline completes and
counts, and the window ends with it. No read repeats: a run whose pool
runs out fails. A traced run's window is one call, under torch.profiler
and the host spans of ``trace.py``. Then the peak memory is read, the
program's state freed, and a sample of the window's answers is held
against the reference (``check.py``).
"""

from __future__ import annotations

import gc
import importlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import check, program
from .gen import graph_generator
from .gen.reads import ReadMaker, stream_seed

HERE = Path(__file__).resolve().parent
# modules that may not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "graphaligner_tpu")
# the read streams of a run (the graph's seed is stream 0)
POOL, WARMUP = 1, 2


class PoolExhausted(RuntimeError):
    pass


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int = 1
    metrics: list = field(default_factory=list)  # [(name, unit)], trace 0
    traced: list = field(default_factory=list)  # [(name, unit)], trace 1


def load_cell(spec: dict, name: str, base: Path = HERE) -> Cell:
    """The workload ``name`` of BENCHMARK.json with its configuration,
    traffic mix and metrics, each found by name."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(there are {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((base.parent / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [(m["name"], m["unit"]) for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {n for n, _ in e2e}
    layer = [(m["name"], m["unit"]) for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return Cell(name, config, traffic, int(w["chips"]), e2e, layer)


def reader(metric: str):
    return importlib.import_module(f"{__package__}.metrics.{metric}")


@dataclass
class Run:
    setup_s: float
    stages: dict
    window_s: float
    bases: int
    reads: int
    failed: int
    calls: list  # [(seconds, reads, slices, collector s, full collections)]
    memory_peak_bytes: int
    record: object = None  # trace.Record of a traced run


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float, log=print) -> dict:
    """One run of ``cell``: the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with a traced
    run's ``breakdown``, and ``checks`` last)."""
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    aligner_cfg = cfg["aligner"]
    n_call = int(aligner_cfg["device_batch"])
    stages: dict = {}

    def stage(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        _sync(dev)
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return out

    stages["start"] = time.perf_counter() - t_start  # interpreter, imports
    program.configure(int(aligner_cfg["threads"]))
    if dev.type == "cuda":
        stage("cuda_init", lambda: torch.zeros(1, device=dev))
        torch.cuda.reset_peak_memory_stats(dev)
    stage("extensions", program.load_extensions, dev)
    gen = graph_generator(cfg["generator"])
    sg = stage("graph_gen", gen.build, cfg["graph"], stream_seed(seed, 0))
    graph = stage("graph", program.load_graph, sg.handed)
    arrays = sg.handed["arrays"]
    log(f"graph: {len(arrays[0])} digraph nodes, {sg.n_segments - 1} sites, "
        f"{int(arrays[2].sum()) // 2} bp a strand", file=sys.stderr,
        flush=True)
    for k in ("tables", "reach", "device_tables"):
        stages[k] = 0.0  # a graph past the reach table's limit builds none
    t0 = time.perf_counter()
    aligner = program.make_aligner(graph, aligner_cfg, dev, stages)
    _sync(dev)
    stages["aligner_rest"] = time.perf_counter() - t0 - sum(
        stages[k] for k in ("tables", "reach", "device_tables"))
    maker = ReadMaker(sg, traffic, dev)
    pool = stage("pool", maker.reads, int(traffic["pool_reads"]), seed, POOL,
                 "read")
    warm = maker.reads(int(traffic["warmup_reads"]), seed, WARMUP, "warm")
    stage("warmup", program.align_call, graph, aligner, warm)
    del warm
    setup_s = time.perf_counter() - t_start
    # the set-up split, on standard output before the result line
    log("setup_split " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()} | {"total": setup_s}),
        flush=True)

    answers: dict = {}
    calls = []
    gc_log = _GcLog()
    bases = 0
    record = None
    used = 0

    def one_call(span=None):
        nonlocal used, bases
        batch = pool[used:used + n_call]
        if len(batch) < n_call:
            raise PoolExhausted(
                f"the pool of {len(pool)} reads ran out after {used}: a read "
                "is never aligned twice in a run")
        used += n_call
        n0 = program.launches()
        g0, f0 = gc_log.seconds, gc_log.full
        t0 = time.perf_counter()
        if span is None:
            out = program.align_call(graph, aligner, batch)
        else:
            out = program.align_call(graph, aligner, batch,
                                     lambda: span.span("finalize.encode"))
        _sync(dev)
        calls.append((time.perf_counter() - t0, len(batch),
                      program.launches() - n0, gc_log.seconds - g0,
                      gc_log.full - f0))
        answers.update(out)
        bases += sum(len(s) for _, s, _ in batch)
        return out

    with gc_log:
        if traced:
            from . import trace

            record = _traced_call(one_call, dev, trace)
            window_s = record.window_s
        else:
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while True:
                one_call()
                if time.perf_counter() >= deadline:
                    break
            window_s = time.perf_counter() - t0
    for i, (s, n, k, g, f) in enumerate(calls):
        log(f"call {i}: {n} reads in {s:.4f} s, {k} slices, collector "
            f"{g:.4f} s ({f} full)", file=sys.stderr, flush=True)
    log(f"gc: {gc_log.full} collections of the oldest generation, "
        f"{gc_log.seconds:.3f} s in all collections of the window",
        file=sys.stderr, flush=True)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    reads = pool[:used]
    del aligner, graph, pool
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(setup_s, stages, window_s, bases, len(reads),
              sum(1 for name, _, _ in reads
                  if name not in answers or answers[name][0]),
              calls, peak, record)
    if record is not None:
        record.int32_rate = _int32_rate(dev)  # nvidia-smi, after the window
    wanted = cell.traced if traced else cell.metrics
    metrics = {}
    for name, unit in wanted:
        value = reader(name).read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}

    correct, numbers, n_ref, ref_s = check.check(
        answers, reads, sg.handed, aligner_cfg, int(traffic["check_reads"]),
        seed)
    log(f"reference: {n_ref} sampled reads in {ref_s:.3f} s", file=sys.stderr,
        flush=True)
    result = {
        "correct": correct,
        "attempted": len(reads),
        "failed": run.failed,
        "metrics": metrics,
        "device": _device(dev, cell.chips, peak, record),
    }
    if record is not None:
        result["breakdown"] = record.breakdown()
    check.print_numbers(numbers)
    result["checks"] = numbers
    return result


def _traced_call(one_call, dev, trace):
    """One call under torch.profiler and the host spans; its Record. The
    work (the reads' band cells, the traces' steps) is summed after."""
    from torch.profiler import ProfilerActivity, profile

    spans = trace.Spans()
    acts = [ProfilerActivity.CUDA if dev.type == "cuda"
            else ProfilerActivity.CPU]
    n0 = program.launches()
    with spans.installed(program.traced_methods()):
        with profile(activities=acts) as prof:
            t0 = time.time_ns()
            out = one_call(spans)
            t1 = time.time_ns()
    events = trace.device_events(prof) if dev.type == "cuda" else []
    cells = sum(c for failed, _, c in out.values() if not failed)
    return trace.Record(t0, t1, events, spans, program.launches() - n0,
                        cells)


class _GcLog:
    """Seconds the collector ran while it is entered, and its collections
    of the oldest generation: the window's host time the program spends
    collecting, on standard error."""

    def __init__(self):
        self.seconds = 0.0
        self.full = 0
        self._t0 = 0.0

    def _watch(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.full += info["generation"] == 2

    def __enter__(self):
        gc.callbacks.append(self._watch)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._watch)


def _int32_rate(dev) -> float:
    if dev.type != "cuda":
        return 0.0
    from .yardstick import int32_rate

    return int32_rate(dev.index or 0)


def _device(dev, chips, peak, record) -> dict:
    out = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": chips,
        "memory_peak_bytes": int(peak),
    }
    if record is not None:
        out["busy_s"] = record.busy_s
        out["window_s"] = record.window_s
    return out


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold,
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
