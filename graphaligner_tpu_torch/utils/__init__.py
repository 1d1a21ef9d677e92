# Port of graphaligner_tpu/utils/__init__.py: the JAX package's metrics module
# is replaced here by the port's tracer (utils/trace.py).
"""Shared utilities: line-atomic logging; the port's tracer (``trace``)."""

from .logging import BufferedWriter  # noqa: F401
