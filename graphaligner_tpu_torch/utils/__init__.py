# Copy of graphaligner_tpu/utils/__init__.py for the torch port (imports point at graphaligner_tpu_torch).
"""Shared utilities: line-atomic logging, timing/metrics."""

from .logging import BufferedWriter  # noqa: F401
from .metrics import AlignMetrics  # noqa: F401
