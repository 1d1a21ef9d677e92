"""The harness finds everything by name, runs a tiny cell end to end on the
CPU with the kernels' plain versions, and refuses to measure without a
card; nothing the benchmark runs loads JAX or the JAX package."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cuda_bench import bench
from cuda_bench.tests.tiny import tiny_cell

CB = Path(__file__).resolve().parents[1]
ROOT = CB.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_everything_is_found_by_name():
    names = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = bench.load_cell(SPEC, w["name"])
        assert cell.config["name"] == w["config"] in names
        assert (CB / "gen" / f"{cell.config['generator']}.py").exists()
        assert cell.traffic["read_len"]
        assert [n for n, _ in cell.metrics] == ["bp_per_s", "setup_s"]
        assert cell.traced
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]).read)
    assert all(m.get("workloads", [""])[0] for m in SPEC["per_layer"])


def test_the_configs_files_hold_what_benchmark_json_says():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg["graph"] for k in c["reduced"])


@pytest.mark.parametrize("at,strand", [("uniform", "both"),
                                       ("first", "forward")])
def test_tiny_cell_runs_end_to_end_on_the_cpu(at, strand):
    cell = tiny_cell(seed={"at": at, "strand": strand})
    lines = []
    out = bench.measure(cell, 2**31 + 99, 0.01, False, "cpu", 0.0,
                        log=lambda *a, **k: lines.append((a[0], k)))
    split = [json.loads(line[len("setup_split "):]) for line, k in lines
             if line.startswith("setup_split") and "file" not in k]
    assert len(split) == 1
    assert {"start", "extensions", "graph_gen", "graph", "tables",
            "device_tables", "reach", "pool", "warmup", "total"} <= set(
                split[0])
    assert out["correct"] is True
    assert out["attempted"] == 4 and out["failed"] == 0
    assert set(out["metrics"]) == {"bp_per_s", "setup_s"}
    assert out["metrics"]["bp_per_s"]["value"] > 0
    assert list(out)[-1] == "checks"
    assert {v["value"] for v in out["checks"].values()} == {0}


def test_tiny_traced_cell_reports_its_host_spans():
    cell = tiny_cell()
    out = bench.measure(cell, 5, 0.01, True, "cpu", 0.0,
                        log=lambda *a, **k: None)
    assert out["correct"] is True
    m = out["metrics"]
    # the CPU has no device trace: only the host spans are read
    assert set(m) == {"scan_share", "walk_share", "finalize_share"}
    assert 0 < m["scan_share"]["value"] + m["walk_share"]["value"] \
        + m["finalize_share"]["value"] <= 1
    assert out["device"]["window_s"] > 0


def test_pool_that_runs_out_fails_the_run():
    cell = tiny_cell(pool_reads=6)
    with pytest.raises(bench.PoolExhausted):
        bench.measure(cell, 1, 1e9, False, "cpu", 0.0,
                      log=lambda *a, **k: None)


def test_the_measuring_entry_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    p = subprocess.run(
        [sys.executable, str(CB / "run.py"), "--workload",
         "chr20_1kg_af05.hifi13k", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in p.stderr


def test_a_run_leaves_no_jax_module_loaded():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from cuda_bench import bench\n"
        "from cuda_bench.tests.tiny import tiny_cell\n"
        "out = bench.measure(tiny_cell(), 3, 0.01, False, "
        "'cpu', 0.0, log=lambda *a, **k: None)\n"
        "assert out['correct']\n"
        "print(bench.forbidden_modules())\n" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "graphaligner_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert bench.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "graphaligner_tpu.core", sys)
    assert "graphaligner_tpu" in bench.forbidden_modules()


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (CB / "reference").glob("*.py"):
        assert not _imports(path) & {"graphaligner_tpu_torch",
                                     "graphaligner_tpu", "jax", "torch"}, path
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import cuda_bench.reference.seeded, cuda_bench.reference.native\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT)
    tops = json.loads(p.stdout.strip().replace("'", '"'))
    assert "graphaligner_tpu_torch" not in tops and "torch" not in tops


def test_the_benchmark_loads_no_jax_era_file():
    old = {"bench", "bench_biggraph", "bench_configs", "bench_mesh_scaling",
           "profile_battery", "profile_e2e", "profile_micro", "profile_scan",
           "profile_scan_common", "profile_walk", "verify_tpu",
           "chip_smoke", "compare_k1_proj", "graphaligner_tpu", "jax",
           "jaxlib", "flax"}
    for path in CB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & old, path
        text = path.read_text()
        assert "BENCH_r0" not in text and "BASELINE.json" not in text, path
