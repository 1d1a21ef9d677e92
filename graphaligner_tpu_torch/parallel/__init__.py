# Port of graphaligner_tpu/parallel/__init__.py.
"""Device-mesh / multi-process parallelism (no reference counterpart — the
reference is single-process pthreads over a shared read queue,
Aligner.cpp:107-117, 285-298)."""

from .mesh import Mesh, make_mesh, shard_reads_aligner  # noqa: F401
