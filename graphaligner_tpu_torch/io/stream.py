# Copy of graphaligner_tpu/io/stream.py for the torch port (the native codec in iter_messages and write_payloads: no pure-Python fallback there).
"""vg "stream" framing: gzip-wrapped varint-framed message groups.

Wire layout (reference: stream.hpp:25-111): a gzip stream containing
repeated groups of [varint64 count][count × (varint32 size, message
bytes)]. Readers must tolerate multiple gzip members concatenated in one
file and multiple groups per member.

Decompression, framing and compression of whole files run in the native
library (native/ga_native.cpp, built by io.native). The shard merge streams
instead: ``iter_payloads_file`` and ``PayloadStreamWriter`` hold a few
chunks at a time, through zlib, and write the same bytes.
"""

from __future__ import annotations

import zlib
from typing import Iterable, Iterator

from . import wire


def _decompress_all(data: bytes) -> bytes:
    """Decompress possibly-concatenated gzip members (or raw data)."""
    if data[:2] != b"\x1f\x8b":
        return data
    out = bytearray()
    pos = 0
    while pos < len(data) and data[pos : pos + 2] == b"\x1f\x8b":
        d = zlib.decompressobj(wbits=31)
        out += d.decompress(data[pos:])
        if not d.eof:
            raise ValueError("truncated gzip stream")
        consumed = len(data) - pos - len(d.unused_data)
        pos += consumed
    return bytes(out)


def iter_messages(data: bytes) -> Iterator[bytes]:
    """Yield raw message payloads from framed (possibly gzipped) bytes."""
    from . import native

    raw = native.gunzip(data) if data[:2] == b"\x1f\x8b" else data
    offsets, lengths = native.frame_offsets(raw)
    for off, ln in zip(offsets, lengths):
        yield raw[off : off + ln]


def _try_varint(buf, pos: int):
    """decode_varint that returns None instead of raising when the buffer
    ends mid-varint (incremental parsing)."""
    result = 0
    shift = 0
    p = pos
    n = len(buf)
    while p < n:
        b = buf[p]
        p += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, p
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")
    return None


def iter_payloads_file(path: str, chunk_size: int = 1 << 20) -> Iterator[bytes]:
    """Stream raw message payloads from a (possibly gzipped) vg stream
    file WITHOUT materializing it: decompression and frame parsing run
    incrementally over fixed-size chunks, so memory stays bounded at a
    few chunk_sizes regardless of file size (the pangenome-scale shard
    merge requirement)."""
    with open(path, "rb") as f:
        head = f.read(2)
        if not head:
            return
        if head == b"\x1f\x8b":

            def chunks() -> Iterator[bytes]:
                d = zlib.decompressobj(wbits=31)
                pending = head
                fresh = True  # current member has consumed no bytes yet
                while True:
                    if not pending and not d.unconsumed_tail:
                        pending = f.read(chunk_size)
                        if not pending:
                            if not fresh and not d.eof:
                                raise ValueError("truncated gzip stream")
                            return
                    if d.unconsumed_tail:
                        feed = d.unconsumed_tail
                    else:
                        feed = pending
                        pending = b""
                    # max_length bounds the OUTPUT (a 1 MB compressed
                    # chunk of repetitive data can inflate to 100+ MB in
                    # one call — the whole point here is bounded memory)
                    out = d.decompress(feed, chunk_size)
                    fresh = False
                    if out:
                        yield out
                    if d.eof:
                        # possibly another gzip member follows
                        pending = d.unused_data + pending
                        d = zlib.decompressobj(wbits=31)
                        fresh = True

            src = chunks()
        else:

            def chunks() -> Iterator[bytes]:
                yield head
                while True:
                    c = f.read(chunk_size)
                    if not c:
                        return
                    yield c

            src = chunks()

        buf = bytearray()
        pos = 0
        in_group = 0
        done = False
        while True:
            while True:
                if pos and (pos > (1 << 22) or pos == len(buf)):
                    del buf[:pos]
                    pos = 0
                if in_group == 0:
                    v = _try_varint(buf, pos)
                    if v is None:
                        break
                    in_group, pos = v
                    continue
                v = _try_varint(buf, pos)
                if v is None:
                    break
                size, p2 = v
                if len(buf) - p2 < size:
                    break
                yield bytes(buf[p2 : p2 + size])
                pos = p2 + size
                in_group -= 1
            if done:
                if in_group or pos != len(buf):
                    raise ValueError("truncated stream frame")
                return
            nxt = next(src, None)
            if nxt is None:
                done = True
            else:
                buf += nxt


class PayloadStreamWriter:
    """Incremental write_payloads: payloads are framed in groups of
    group_size and pushed through ONE zlib gzip stream, so the on-disk
    bytes are identical to write_payloads() of the full list while only
    the current group is ever held in memory (zlib writes mtime=0 and
    OS=3 with wbits=31 on Unix, same container bytes as the native
    ga_gzip path)."""

    def __init__(self, path: str, group_size: int = 1000):
        self._f = open(path, "wb")
        self._group: list = []
        self._gs = group_size
        self._count = 0
        self._comp = zlib.compressobj(6, zlib.DEFLATED, 31)

    def write(self, payload: bytes) -> None:
        self._group.append(payload)
        self._count += 1
        if len(self._group) >= self._gs:
            self._flush_group()

    def _flush_group(self) -> None:
        framed = frame_payloads(self._group, self._gs)
        self._group = []
        out = self._comp.compress(framed)
        if out:
            self._f.write(out)

    def close(self) -> int:
        if self._group or self._count == 0:
            self._flush_group()
        self._f.write(self._comp.flush())
        self._f.close()
        return self._count

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


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
