"""On the card: a tiny cell of the configuration, plain and traced, is
correct and its traced run reads every per-layer metric of its cell.

    python -m pytest cuda_bench/tests/test_cb_cuda.py -q   (on the card)
"""

import pytest

from cuda_bench import bench
from cuda_bench.tests.tiny import tiny_cell

QUIET = {"log": lambda *a, **k: None}


@pytest.mark.cuda
def test_tiny_cell_on_the_card(cuda, monkeypatch):
    # the full graph is past the reach table's limit: project as it does
    monkeypatch.setenv("GA_REACH_MAXN", "0")
    cell = tiny_cell(device_batch=64, pool_reads=192)
    out = bench.measure(cell, 2**31 + 17, 0.01, False, cuda, 0.0, **QUIET)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    traced = bench.measure(cell, 2**31 + 18, 0.01, True, cuda, 0.0, **QUIET)
    assert traced["correct"] is True
    m = traced["metrics"]
    assert {n for n, _ in cell.traced} <= set(m)
    assert 0 < m["k1_roofline"]["value"] <= 100
    assert 0 < m["k2_roofline"]["value"] <= 100
    assert 0 <= m["idle_share"]["value"] < 1
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    assert traced["breakdown"]["device_ops"]
