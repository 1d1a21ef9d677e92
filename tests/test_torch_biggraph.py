"""The port's big-graph generator against tests/biggraph_util.py.

``graphaligner_tpu_torch.graph.synthetic`` rebuilds the JAX package's
synthetic variation graph from the same seed without a Python loop over
segments; the big-graph corpus (``tests/fixtures/torch/biggraph_b35``)
relies on the two being the same graph. Held here at small sizes, node for
node and edge for edge, with the same reads.
"""

import pathlib
import sys

import numpy as np
import pytest

from graphaligner_tpu_torch.graph.synthetic import (
    graph_checksum,
    make_big_graph,
    make_reads,
)

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from biggraph_util import make_big_graph as jax_make_big_graph  # noqa: E402
from biggraph_util import make_reads as jax_make_reads  # noqa: E402

ARRAYS = ("node_ids", "reverse", "node_len", "node_start", "node_end",
          "seq_codes", "pos_to_node", "in_ptr", "in_idx", "out_ptr",
          "out_idx", "comp_id", "comp_cyclic", "topo_node_order")


@pytest.mark.parametrize("n_segments", [1, 4, 5, 2000, 2003])
def test_make_big_graph_matches_the_jax_helper(n_segments):
    want, w_backbone, w_seq = jax_make_big_graph(n_segments)
    got, g_backbone, g_seq = make_big_graph(n_segments)
    assert g_seq == w_seq
    assert list(g_backbone) == list(w_backbone)
    for key in ARRAYS:
        a, b = np.asarray(getattr(got, key)), np.asarray(getattr(want, key))
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.node_lookup == want.node_lookup
    assert (got.num_comps, got.dbg_overlap, vars(got.stats)) == (
        want.num_comps, want.dbg_overlap, vars(want.stats))
    assert graph_checksum(got) == graph_checksum(want)


def test_make_reads_matches_the_jax_helper():
    want, w_backbone, w_seq = jax_make_big_graph(2000)
    got, g_backbone, g_seq = make_big_graph(2000)
    assert (make_reads(g_seq, 5, 1024, got, g_backbone)
            == jax_make_reads(w_seq, 5, 1024, want, w_backbone))


def test_graph_checksum_sees_one_base():
    graph, _, _ = make_big_graph(50)
    before = graph_checksum(graph)
    graph.seq_codes[7] ^= 1
    assert graph_checksum(graph) != before
