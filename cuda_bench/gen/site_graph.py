"""The shape every generated graph shares: a backbone of segments with a
site between each two, each site a list of alleles, its first the
reference allele (an empty allele is the direct edge from one segment to
the next). Segments and alleles are cut into nodes of ``max_node`` bp, the
last one shorter, as ``vg construct -m`` cuts them.

Read generation walks this model (``gen.reads``); the program and the
reference each build their graph from ``handed``, what the benchmark hands
to both sides: the digraph's arrays (``{"arrays": (node_ids, reverse,
node_len, seq_codes, edge_from, edge_to)}``, as
``AlignmentGraph.from_arrays`` takes them). Sequences in the model are
indices into "ACGT".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SiteGraph:
    handed: dict
    seg_codes: np.ndarray  # uint8, the segments back to back
    seg_off: np.ndarray  # int64 [n + 1]
    seg_node: np.ndarray  # int64 [n], each segment's first bigraph node id
    site_ptr: np.ndarray  # int64 [n]: site i's alleles are rows ptr[i]:ptr[i+1]
    allele_codes: np.ndarray  # uint8, the alleles back to back
    allele_off: np.ndarray  # int64 [alleles + 1]
    allele_node: np.ndarray  # int64 [alleles], first node id (0: empty)
    max_node: int  # bp a node holds at most
    alt_share: float  # a haplotype leaves a site's reference allele so often

    @property
    def n_segments(self) -> int:
        return len(self.seg_node)
