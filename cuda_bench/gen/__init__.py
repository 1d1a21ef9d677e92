"""Input generators: one module a graph generator, found by the name a
configuration gives (``gen/<generator>.py``, a ``build(graph, seed)``
returning a ``site_graph.SiteGraph``), and ``reads``, the one read
generator every traffic mix's parameters drive."""

from __future__ import annotations

import importlib


def graph_generator(name: str):
    return importlib.import_module(f"{__name__}.{name}")
