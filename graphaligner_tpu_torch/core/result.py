# Copy of graphaligner_tpu/core/result.py for the torch port (imports point at graphaligner_tpu_torch).
"""Alignment result and trace types (reference GraphAlignerWrapper.h:11-50)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..io import vg

INT32_MAX = 2**31 - 1


class TraceMatchType(enum.IntEnum):
    MATCH = 1
    MISMATCH = 2
    INSERTION = 3
    DELETION = 4
    FORWARDBACKWARDSPLIT = 5


@dataclass
class TraceItem:
    node_id: int
    offset: int
    reverse: bool
    readpos: int
    type: TraceMatchType
    graph_char: str
    read_char: str


class LazyTrace(list):
    """Trace-item list materialized on first access — the per-step
    TraceItem construction (getTraceInfo, GraphAligner.h:690-780) costs
    ~1ms/read in Python, and is only needed when trace files are
    actually written."""

    def __init__(self, thunk):
        super().__init__()
        self._thunk = thunk

    def _materialize(self):
        if self._thunk is not None:
            self.extend(self._thunk())
            self._thunk = None

    def __iter__(self):
        self._materialize()
        return super().__iter__()

    def __len__(self):
        self._materialize()
        return super().__len__()

    def __getitem__(self, i):
        self._materialize()
        return super().__getitem__(i)

    def __bool__(self):
        self._materialize()
        return super().__len__() > 0


@dataclass
class AlignmentResult:
    alignment: vg.Alignment = field(default_factory=vg.Alignment)
    alignment_failed: bool = True
    cells_processed: int = 0
    elapsed_milliseconds: int = 0
    alignment_start: int = 0
    alignment_end: int = 0
    trace: list = field(default_factory=list)


def empty_alignment(elapsed_ms: int, cells_processed: int) -> AlignmentResult:
    aln = vg.Alignment(score=INT32_MAX)
    return AlignmentResult(
        alignment=aln,
        alignment_failed=True,
        cells_processed=cells_processed,
        elapsed_milliseconds=elapsed_ms,
    )


class LazyAlignment:
    """Deferred vg.Alignment: holds merged per-mapping run ARRAYS and
    materializes the message object (or its wire bytes) only when
    something actually reads the path — object construction costs
    ~1-3ms per long read and the batched pipeline often only needs the
    score. Attribute-compatible with vg.Alignment for every consumer in
    the runtime (score/name/sequence/query_position/path/encode)."""

    __slots__ = ("name", "sequence", "score", "query_position", "_graph", "_runs", "_obj")

    def __init__(self, graph, name, sequence, score, query_position, runs):
        self.name = name
        self.sequence = sequence
        self.score = score
        self.query_position = query_position
        self._graph = graph
        self._runs = runs
        self._obj = None

    def _build(self) -> vg.Alignment:
        if self._obj is None:
            aln = vg.Alignment(
                name=self.name,
                sequence=self.sequence,
                score=self.score,
                query_position=self.query_position,
                path=vg.Path(),
            )
            r = self._runs
            if r is not None:
                node_id = r["node_id"].tolist()
                rev = r["rev"].tolist()
                offsets = r["offsets"].tolist()
                ranks = r["ranks"].tolist()
                from_len = r["from_len"].tolist()
                to_len = r["to_len"].tolist()
                rstart = r["rstart"].tolist()
                seq = self.sequence
                Mapping, Position, Edit = vg.Mapping, vg.Position, vg.Edit
                mappings = aln.path.mapping
                for i in range(len(node_id)):
                    tl = to_len[i]
                    rs = rstart[i]
                    m = Mapping(
                        position=Position(
                            node_id=node_id[i],
                            offset=offsets[i],
                            is_reverse=bool(rev[i]),
                        ),
                        rank=ranks[i],
                        edit=[
                            Edit(
                                from_length=from_len[i],
                                to_length=tl,
                                sequence=seq[rs : rs + tl],
                            )
                        ],
                    )
                    mappings.append(m)
            self._obj = aln
        return self._obj

    @property
    def path(self):
        return self._build().path

    def encode(self) -> bytes:
        return self._build().encode()

    def __repr__(self):
        return repr(self._build())

    def __eq__(self, other):
        if isinstance(other, LazyAlignment):
            other = other._build()
        return self._build() == other


class PayloadAlignment:
    """A vg.Alignment held as its serialized wire payload (produced by
    the native encoder); decodes lazily if something needs the object."""

    __slots__ = ("payload", "_obj", "name")

    def __init__(self, payload: bytes, name: str | None = None):
        self.payload = payload
        self._obj = None
        # `name` stays an UNSET slot when unknown, so attribute access
        # falls through __getattr__ to the lazy decode
        if name is not None:
            self.name = name

    def _build(self) -> vg.Alignment:
        if self._obj is None:
            self._obj = vg.Alignment.decode(self.payload)
        return self._obj

    def encode(self) -> bytes:
        return self.payload

    def __getattr__(self, name):
        return getattr(self._build(), name)

    def __repr__(self):
        return repr(self._build())

    def __eq__(self, other):
        if isinstance(other, PayloadAlignment):
            return self.payload == other.payload
        return self._build() == other
