# Copy of graphaligner_tpu/io/stream.py for the torch port (the native codec only: no pure-Python fallback, no streaming shard-merge reader or writer).
"""vg "stream" framing: gzip-wrapped varint-framed message groups.

Wire layout (reference: stream.hpp:25-111): a gzip stream containing
repeated groups of [varint64 count][count × (varint32 size, message
bytes)]. Readers must tolerate multiple gzip members concatenated in one
file and multiple groups per member.

Decompression, framing and compression run in the native library
(native/ga_native.cpp, built by io.native).
"""

from __future__ import annotations

from typing import Iterable, Iterator

from . import wire


def iter_messages(data: bytes) -> Iterator[bytes]:
    """Yield raw message payloads from framed (possibly gzipped) bytes."""
    from . import native

    raw = native.gunzip(data) if data[:2] == b"\x1f\x8b" else data
    offsets, lengths = native.frame_offsets(raw)
    for off, ln in zip(offsets, lengths):
        yield raw[off : off + ln]


def read_messages(path: str, message_cls) -> list:
    """Read all messages of ``message_cls`` from a GAM/VG stream file."""
    with open(path, "rb") as f:
        data = f.read()
    return [message_cls.decode(m) for m in iter_messages(data)]


def frame_messages(messages: Iterable, group_size: int = 1000) -> bytes:
    """Frame encoded messages into uncompressed stream layout."""
    return frame_payloads([m.encode() for m in messages], group_size)


def frame_payloads(payloads: list, group_size: int = 1000) -> bytes:
    """Frame already-encoded message payloads (no protobuf decode/encode
    round trip — the streaming-merge path)."""
    out = bytearray()
    for start in range(0, len(payloads), group_size) or [0]:
        group = payloads[start : start + group_size]
        out += wire.encode_varint(len(group))
        for p in group:
            out += wire.encode_varint(len(p))
            out += p
    if not payloads:
        out += wire.encode_varint(0)
    return bytes(out)


def write_payloads(path: str, payloads: list, group_size: int = 1000) -> None:
    """Write raw message payloads as a gzip-compressed vg stream file —
    byte-identical to write_messages of the decoded objects, without
    touching protobuf."""
    from . import native

    framed = frame_payloads(payloads, group_size)
    with open(path, "wb") as f:
        f.write(native.gzip_bytes(framed, level=6))


def write_messages(path: str, messages: Iterable, group_size: int = 1000) -> None:
    """Write messages as a gzip-compressed vg stream (GAM) file."""
    from . import native

    framed = frame_messages(messages, group_size)
    with open(path, "wb") as f:
        f.write(native.gzip_bytes(framed, level=6))
