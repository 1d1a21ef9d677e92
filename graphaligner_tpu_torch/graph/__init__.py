# Copy of graphaligner_tpu/graph/__init__.py for the torch port (without the bluntify note).
"""Graph preprocessing layer (reference L1).

bigraph   — bidirected vg/GFA → doubled digraph conversion
alignment_graph — the runtime graph index as flat numpy/device arrays
scc       — SCC condensation + topological order (host-side precompute)
"""

from .alignment_graph import AlignmentGraph  # noqa: F401
from .bigraph import (  # noqa: F401
    graph_from_gfa_file,
    graph_from_vg_file,
    load_alignment_graph,
)
