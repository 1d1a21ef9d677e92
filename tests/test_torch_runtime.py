"""The port's align_reads and CLI, its device rule and what it does not
port.

- The CLI (``--backend cpu``) writes the same GAM and trace files as the
  reference binary's goldens in seeded mode, and the JAX-made goldens in
  exhaustive mode (-i).
- In a subprocess where ``import jax`` and ``import graphaligner_tpu`` both
  fail, the port still aligns smallexample through its CLI, seeded and -i,
  and the small multi-allelic corpus (in-degree 8) seeded, and imports its
  ``parallel`` package: it needs neither.
- Asking for ``cuda`` with no GPU raises; so does every unported route.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

from graphaligner_tpu.io import stream, vg

FIX = pathlib.Path(__file__).parent / "fixtures"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _by_name(path):
    return {a.name: a for a in stream.read_messages(str(path), vg.Alignment)}


def test_cli_writes_golden_gam(tmp_path, monkeypatch):
    from graphaligner_tpu_torch.runtime import cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    sim = FIX / "sim"
    rc = cli.main([
        "-g", str(sim / "bubbles.vg"), "-f", str(sim / "sim.fastq"),
        "-s", str(sim / "seeds.gam"), "-b", "35", "-a", "out.gam",
        "--backend", "cpu",
    ])
    assert rc == 0
    out = _by_name(tmp_path / "out.gam")
    assert out == _by_name(sim / "golden_b35" / "out.gam")
    # per-read files as the reference Aligner writes them
    for name in out:
        assert (tmp_path / f"alignment_0_{name}.gam").exists()
        assert (tmp_path / f"trace_0_{name}.trace").exists()


def test_cli_i_writes_jax_golden_gam(tmp_path, monkeypatch):
    from graphaligner_tpu_torch.runtime import cli

    monkeypatch.chdir(tmp_path)
    sim = FIX / "sim"
    rc = cli.main([
        "-g", str(sim / "bubbles.vg"), "-f", str(sim / "sim.fastq"),
        "-s", str(sim / "seeds.gam"), "-b", "35", "-i", "-a", "out.gam",
        "--backend", "cpu",
    ])
    assert rc == 0
    got = stream.read_messages(str(tmp_path / "out.gam"), vg.Alignment)
    want = stream.read_messages(str(FIX / "torch" / "sim_i" / "out.gam"),
                                vg.Alignment)
    assert [a.encode() for a in got] == [a.encode() for a in want]
    assert len(got) == 20
    for a in got:
        assert (tmp_path / f"alignment_0_{a.name}.gam").exists()
        assert (tmp_path / f"trace_0_{a.name}.trace").exists()


# The head of a script run with the repository root as its first argument:
# ``import jax`` and ``import graphaligner_tpu`` fail in it. A script that
# ends with NO_JAX_LOADED fails if any module of either was loaded anyway.
BLOCK_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["graphaligner_tpu"] = None
sys.path.insert(0, sys.argv[1])
"""
NO_JAX_LOADED = r"""
loaded = [m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "graphaligner_tpu"))]
assert not loaded, f"imported {loaded}"
"""

_NO_JAX = BLOCK_JAX + r"""
import graphaligner_tpu_torch.parallel.components  # noqa: F401
import graphaligner_tpu_torch.parallel.distributed  # noqa: F401
import graphaligner_tpu_torch.parallel.mesh  # noqa: F401
from graphaligner_tpu_torch.runtime import cli
rc = cli.main(sys.argv[2:])
""" + NO_JAX_LOADED + r"""
sys.exit(rc)
"""


def _run_without_jax(tmp_path, *args, graph=None, reads=None, bw="35"):
    small = FIX / "smallexample"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(ROOT),
         "-g", str(graph or small / "sub_test.vg"),
         "-f", str(reads or small / "read.fastq"),
         "-b", bw, "-a", "out.gam", "--backend", "cpu", *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return stream.read_messages(str(tmp_path / "out.gam"), vg.Alignment)


def test_port_runs_where_jax_is_absent(tmp_path):
    small = FIX / "smallexample"
    got = _run_without_jax(tmp_path, "-s", str(small / "seedalignment.gam"))
    want = stream.read_messages(str(FIX / "golden" / "seeded.gam"),
                                vg.Alignment)
    assert [a.encode() for a in got] == [a.encode() for a in want]
    trace = (tmp_path / "trace_0_read1.trace").read_text()
    assert trace == (FIX / "golden" / "trace_0_read1.trace").read_text()
    # in-degree 8 (K1's and K2's wide routes), against the JAX golden
    ma = FIX / "torch" / "multiallelic_small"
    got = _run_without_jax(tmp_path, "-s", str(ma / "seeds.gam"), "-B", "20",
                           graph=ma / "graph.gfa", reads=ma / "reads.fastq",
                           bw="5")
    want = _by_name(ma / "out_b5_B20.gam")
    assert len(got) == 6
    assert {a.name: a.encode() for a in got} == {
        n: a.encode() for n, a in want.items()}


def test_port_runs_i_where_jax_is_absent(tmp_path):
    got = _run_without_jax(tmp_path, "-i")
    want = stream.read_messages(
        str(FIX / "torch" / "smallexample_i" / "out.gam"), vg.Alignment
    )
    assert len(got) == 1
    assert [a.encode() for a in got] == [a.encode() for a in want]


def test_cuda_request_without_gpu_raises(monkeypatch):
    from graphaligner_tpu_torch._device import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        get_device("cuda")
    assert get_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        get_device("meta")


def test_cuda_tensor_without_gpu_raises_in_kernel_wrapper(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: never the plain path."""
    from graphaligner_tpu_torch.ops import _build

    def no_nvcc(name):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "library", no_nvcc)
    from graphaligner_tpu_torch.ops import banded_cell as k1

    Nm, Cm, B, N = 3, 4, 2, 5
    i = torch.int32
    z = lambda *shape, dtype=i: torch.zeros(shape, dtype=dtype)  # noqa: E731
    args = (z(Nm, B), z(B, dtype=torch.bool), z(Nm, B), z(Nm, B), z(Nm, B),
            z(Cm, B), z(B), z(B, dtype=torch.bool), z(B, dtype=torch.bool),
            z(B), z(B, 64, dtype=torch.uint8), z(B), z(N), z(N), z(N, 2),
            z(8), z(15))
    n0 = k1.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc"):
        k1._launch(*args, P_fix=16)
    assert k1.LAUNCHES == n0


def test_unported_routes_raise(tmp_path, monkeypatch):
    """The mesh and the multi-process flags run now (tests/
    test_torch_parallel.py, test_torch_multihost.py); what they cannot do
    raises instead of falling back: a mesh on ``cuda`` with no card, a
    component shard without seeds, a process id outside the group."""
    from graphaligner_tpu_torch.core.params import AlignerParams
    from graphaligner_tpu_torch.parallel import distributed, make_mesh
    from graphaligner_tpu_torch.runtime import cli
    from graphaligner_tpu_torch.runtime.aligner import align_reads

    monkeypatch.chdir(tmp_path)
    sim = FIX / "sim"
    base = ["-g", str(sim / "bubbles.vg"), "-f", str(sim / "sim.fastq"),
            "-b", "35"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(base + ["-s", str(sim / "seeds.gam"), "--mesh", "dp",
                         "--backend", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    params = AlignerParams(graph_file=str(sim / "bubbles.vg"),
                           fastq_file=str(sim / "sim.fastq"),
                           initial_bandwidth=35, initial_full_band=True)
    with pytest.raises(ValueError, match="seed file"):
        align_reads(params, log=lambda *a: None, backend="cpu",
                    process_index=0, process_count=2,
                    shard_mode="components")
    with pytest.raises(ValueError, match="process-id"):
        distributed.initialize("localhost:1", 2, 2)
