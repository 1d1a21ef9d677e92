# Copy of graphaligner_tpu/utils/logging.py for the torch port (imports point at graphaligner_tpu_torch).
"""Line-atomic buffered logging (reference BufferedWriter,
CommonUtils.h:17-34): workers accumulate partial lines and flush whole
lines at once so concurrent output never interleaves mid-line."""

from __future__ import annotations

import sys
import threading

_global_lock = threading.Lock()


class BufferedWriter:
    def __init__(self, stream=None):
        self._stream = stream if stream is not None else sys.stdout
        self._parts: list = []

    def write(self, *items) -> "BufferedWriter":
        self._parts.extend(str(x) for x in items)
        return self

    def __lshift__(self, item) -> "BufferedWriter":
        return self.write(item)

    def flush(self) -> None:
        line = "".join(self._parts) + "\n"
        self._parts.clear()
        with _global_lock:
            self._stream.write(line)
            self._stream.flush()
