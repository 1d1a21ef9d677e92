"""The device paths' named limits and the per-read host loop on the CPU.

- With long mode forced (``LONG_WINDOW`` 4) on the small multi-allelic
  corpus (in-degree 8), the seeded batched path raises
  ``NotImplementedError`` (the long walk takes in-degree <= 4). The driver
  lets it propagate, its message naming ``--backend oracle``, with or
  without ``GA_NO_FALLBACK``: nothing is realigned on the host and no GAM
  is written. A launch-limit raise (a kernel's tables past a block's shared
  memory) propagates the same way from either device path.
- ``--backend oracle``, asked for, writes that corpus's JAX golden.
- Any other exception from the batched path propagates unchanged.
- The per-read loop fails only the read that raises, and the host path
  takes no device: ``--backend oracle`` with ``--mesh dp`` runs where CUDA
  is absent.
- The port's native crash guard names the read that ``set_read`` set and
  returns the entry's error value, as the JAX package's does.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

from graphaligner_tpu.io import stream, vg
from test_torch_runtime import BLOCK_JAX

FIX = pathlib.Path(__file__).parent / "fixtures"
ROOT = pathlib.Path(__file__).resolve().parents[1]
MA = FIX / "torch" / "multiallelic_small"
SIM = FIX / "sim"


@pytest.fixture
def no_host_loop(monkeypatch):
    """The driver with its per-read host loop made to fail if it runs."""
    from graphaligner_tpu_torch.runtime import aligner

    def host_loop(*args, **kwargs):
        raise AssertionError("the device path ran the per-read host loop")

    monkeypatch.setattr(aligner, "_align_reads_per_read", host_loop)
    monkeypatch.delenv("GA_NO_FALLBACK", raising=False)
    return aligner


@pytest.fixture
def forced_long(no_host_loop, monkeypatch):
    from graphaligner_tpu_torch.core import batch_align as ba

    # the class attribute: the 2x retry tier reads it too
    monkeypatch.setattr(ba.BandedBatchAligner, "LONG_WINDOW", 4)
    return no_host_loop


def _params(tmp_path, graph=MA / "graph.gfa", reads=MA / "reads.fastq",
            seeds=MA / "seeds.gam"):
    from graphaligner_tpu_torch.core.params import AlignerParams

    return AlignerParams(graph_file=str(graph), fastq_file=str(reads),
                         seed_file=str(seeds),
                         alignment_file=str(tmp_path / "out.gam"),
                         initial_bandwidth=35)


@pytest.mark.parametrize("no_fallback", [None, "1"])
def test_limit_propagates_naming_the_oracle(forced_long, tmp_path,
                                            monkeypatch, no_fallback):
    if no_fallback:
        monkeypatch.setenv("GA_NO_FALLBACK", no_fallback)
    with pytest.raises(NotImplementedError,
                       match=r"in-degree <= 4.*--backend oracle") as info:
        forced_long.align_reads(_params(tmp_path), log=lambda *a: None,
                                output_dir=str(tmp_path), backend="cpu")
    assert isinstance(info.value.__cause__, NotImplementedError)
    assert not (tmp_path / "out.gam").exists()
    assert not list(tmp_path.glob("alignment_0_*.gam"))


@pytest.mark.parametrize("seeded", [True, False])
def test_launch_limit_propagates(no_host_loop, tmp_path, monkeypatch,
                                 seeded):
    """A kernel wrapper's launch-limit raise, from the seeded path or -i,
    reaches the caller; the host loop never runs."""
    from graphaligner_tpu_torch.core import batch_align as ba
    from graphaligner_tpu_torch.core import engine

    def too_big(*args, **kwargs):
        raise NotImplementedError("the block's tables (240000 B) do not fit "
                                  "in shared memory")

    from graphaligner_tpu_torch.core.params import AlignerParams

    if seeded:
        monkeypatch.setattr(ba, "align_reads_seeded_batch", too_big)
        params = _params(tmp_path, SIM / "bubbles.vg", SIM / "sim.fastq",
                         SIM / "seeds.gam")
    else:
        monkeypatch.setattr(engine, "align_batch_full_band", too_big)
        params = AlignerParams(graph_file=str(SIM / "bubbles.vg"),
                               fastq_file=str(SIM / "sim.fastq"),
                               alignment_file=str(tmp_path / "out.gam"),
                               initial_bandwidth=35, initial_full_band=True)
    with pytest.raises(NotImplementedError,
                       match=r"shared memory; --backend oracle"):
        no_host_loop.align_reads(params, log=lambda *a: None,
                                 output_dir=str(tmp_path), backend="cpu")
    assert not (tmp_path / "out.gam").exists()


def test_oracle_writes_the_golden(tmp_path, capsys):
    """Asked for, the per-read host path aligns the corpus the device path
    stops on. The golden holds the reads in file order; the driver writes
    them back-first, as the reference does."""
    from graphaligner_tpu_torch.runtime import aligner

    out = aligner.align_reads(_params(tmp_path), log=lambda *a: None,
                              output_dir=str(tmp_path), backend="oracle")
    assert len(out) == 6
    golden = stream.read_messages(str(MA / "out_b35.gam"), vg.Alignment)
    got = stream.read_messages(str(tmp_path / "out.gam"), vg.Alignment)
    assert [a.encode() for a in got] == [a.encode() for a in golden[::-1]]
    stream.write_messages(str(tmp_path / "want.gam"), golden[::-1])
    assert (tmp_path / "out.gam").read_bytes() == \
        (tmp_path / "want.gam").read_bytes()
    assert "Traceback" not in capsys.readouterr().err
    for a in got:
        assert (tmp_path / f"alignment_0_{a.name}.gam").exists()
        assert (tmp_path / f"trace_0_{a.name}.trace").exists()


@pytest.mark.parametrize("exc", [RuntimeError, ValueError, AssertionError,
                                 torch.cuda.OutOfMemoryError])
def test_other_exceptions_propagate_unchanged(forced_long, tmp_path,
                                              monkeypatch, exc):
    from graphaligner_tpu_torch.core import batch_align as ba

    def fail(*args, **kwargs):
        raise exc("a fault in the batched path")

    monkeypatch.setattr(ba, "align_reads_seeded_batch", fail)
    with pytest.raises(exc, match="^a fault in the batched path$"):
        forced_long.align_reads(_params(tmp_path), log=lambda *a: None,
                                output_dir=str(tmp_path), backend="cpu")


def test_per_read_failure_fails_only_its_read(tmp_path, monkeypatch):
    """A read whose alignment raises is logged and skipped; the loop goes
    on to the next read, whose bytes are the reference's."""
    from graphaligner_tpu_torch.io import load_fastq
    from graphaligner_tpu_torch.runtime import aligner

    reads = load_fastq(str(SIM / "sim.fastq"))[:2]
    subset = tmp_path / "reads.fastq"
    subset.write_text("".join(f"@{r.seq_id}\n{r.sequence}\n+\n{r.quality}\n"
                              for r in reads))
    bad = reads[1].seq_id  # popped first
    orig = aligner.align_one_way_seeded

    def flaky(graph, seq_id, *args, **kwargs):
        if seq_id == bad:
            raise IndexError("a fault in one read")
        return orig(graph, seq_id, *args, **kwargs)

    monkeypatch.setattr(aligner, "align_one_way_seeded", flaky)
    logs = []
    params = _params(tmp_path, SIM / "bubbles.vg", subset, SIM / "seeds.gam")
    out = aligner.align_reads(params, log=logs.append,
                              output_dir=str(tmp_path), backend="oracle")
    assert [a.name for a in out] == [reads[0].seq_id]
    assert f"read {bad} alignment failed (exception!)" in logs
    golden = [a.encode() for a in stream.read_messages(
        str(SIM / "golden_b35" / "out.gam"), vg.Alignment)
        if a.name == reads[0].seq_id]
    got = stream.read_messages(str(tmp_path / "out.gam"), vg.Alignment)
    assert [a.encode() for a in got] == golden
    assert not (tmp_path / f"alignment_0_{bad}.gam").exists()


def test_oracle_takes_no_device(tmp_path, monkeypatch):
    from graphaligner_tpu_torch.runtime import aligner, cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_device(name):
        raise AssertionError("the host path asked for a device")

    monkeypatch.setattr(aligner, "get_device", no_device)
    monkeypatch.chdir(tmp_path)
    small = FIX / "smallexample"
    assert cli.main([
        "-g", str(small / "sub_test.vg"), "-f", str(small / "read.fastq"),
        "-s", str(small / "seedalignment.gam"), "-b", "35", "-a", "out.gam",
        "--backend", "oracle", "--mesh", "dp",
    ]) == 0
    assert (tmp_path / "out.gam").read_bytes() == \
        (FIX / "golden" / "seeded.gam").read_bytes()


_CRASH = BLOCK_JAX + r"""
import ctypes
from graphaligner_tpu_torch.io import native
native.get_lib()  # builds, loads and installs the guard
native.set_read("read_xyz_42")
# null pointers: a SIGSEGV inside the guarded ga_trace_piece2 entry
f = ctypes.CDLL(str(native.library_path())).ga_trace_piece2
f.restype = ctypes.c_int
p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
f.argtypes = [p, i64, i64, i32, p, i64, i64, p, p, p, p, i32, i32, p, p]
n = f(None, 4, 0, 0, None, 63, 0, None, None, None, None, 0, 0, None, None)
print("SURVIVED", n)
"""


def test_native_crash_names_its_read_and_returns():
    """The hook the per-read loop calls before each read: a fault inside a
    native call names that read and returns the entry's error value, so
    the loop fails only that read (tests/test_crash_guard.py, JAX side)."""
    proc = subprocess.run([sys.executable, "-c", _CRASH, str(ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-500:])
    assert "SURVIVED -2" in proc.stdout, proc.stdout
    assert "read_xyz_42" in proc.stderr, proc.stderr[-500:]
