"""The port's copies of the host layers against graphaligner_tpu's.

The port carries its own graph loader, message classes, stream codec and
native library (built from its own copy of the source). Each package reads
the same fixture files; the graph index arrays must be equal and the
messages equal as ``encode()`` bytes, and a GAM the port writes must be
byte-identical to the one the JAX package writes.
"""

import pathlib

import numpy as np
import pytest

from graphaligner_tpu.graph import graph_from_gfa_file, load_alignment_graph
from graphaligner_tpu.io import stream, vg
from graphaligner_tpu_torch.graph import (
    graph_from_gfa_file as t_graph_from_gfa_file,
    load_alignment_graph as t_load_alignment_graph,
)
from graphaligner_tpu_torch.io import stream as t_stream, vg as t_vg

FIX = pathlib.Path(__file__).parent / "fixtures"
GRAPHS = ["smallexample/sub_test.vg", "sim/bubbles.vg", "longsim/graph.vg",
          "sim/cyclic.gfa", "sim/overlap.gfa"]
ARRAYS = ("node_start", "node_len", "node_end", "node_ids", "reverse",
          "seq_codes", "pos_to_node", "in_ptr", "in_idx", "out_ptr",
          "out_idx", "topo_node_order", "comp_cyclic")


@pytest.mark.parametrize("path", GRAPHS)
def test_graph_index_matches_jax(path):
    if path.endswith(".gfa"):
        want = graph_from_gfa_file(str(FIX / path))
        got = t_graph_from_gfa_file(str(FIX / path))
    else:
        want = load_alignment_graph(str(FIX / path))
        got = t_load_alignment_graph(str(FIX / path))
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.node_lookup == want.node_lookup
    assert got.dbg_overlap == want.dbg_overlap
    assert vars(got.stats) == vars(want.stats)


@pytest.mark.parametrize("path,cls", [
    ("longsim/golden_b35.gam", "Alignment"),
    ("sim/seeds.gam", "Alignment"),
    ("sim/bubbles.vg", "Graph"),
])
def test_stream_round_trip_matches_jax(path, cls, tmp_path):
    want = stream.read_messages(str(FIX / path), getattr(vg, cls))
    got = t_stream.read_messages(str(FIX / path), getattr(t_vg, cls))
    assert [m.encode() for m in got] == [m.encode() for m in want]
    stream.write_messages(str(tmp_path / "jax.gam"), want)
    t_stream.write_messages(str(tmp_path / "port.gam"), got)
    assert (tmp_path / "port.gam").read_bytes() == (
        tmp_path / "jax.gam").read_bytes()


def test_native_library_builds_into_build_dir():
    """The port's library is its own: built from its copy of the source
    into build/native/, named by a hash of source and flags."""
    from graphaligner_tpu_torch.io import native

    path = native.build_library()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("libga_native-") and path.exists()
    assert native.SOURCE.parent.parent.name == "graphaligner_tpu_torch"
    assert native.get_lib() is native.get_lib()
