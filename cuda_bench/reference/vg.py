# Frozen copy of graphaligner_tpu_torch/io/vg.py, part of the benchmark's plain reference (imports nothing of the program).
"""The vg ecosystem message schema.

Plain-Python message classes wire-compatible with the vg protobuf schema
used by the reference aligner (schema recovered from the generated
descriptor in the reference's vg.pb.cpp). The reference keeps the
messages an Alignment holds: Edit, Mapping, Position, Path, Alignment,
Locus, Genotype, Support.

Each class declares ``FIELDS``: (field_number, attr_name, kind) where kind
is one of 'string' | 'bytes' | 'int' (varint int32/int64) | 'uint' |
'sint' (zigzag) | 'bool' | 'double' | a message class | a one-element list
[kind] marking a repeated field. Encoding skips proto3 defaults and emits
fields in field-number order, byte-matching the C++ protobuf runtime.
"""

from __future__ import annotations

from . import wire


class Message:
    FIELDS: tuple = ()
    __slots__ = ()

    def __init__(self, **kwargs):
        for _, name, kind in self.FIELDS:
            if isinstance(kind, list):
                default = []
            elif isinstance(kind, type) or kind == "msg_self":
                default = None
            elif kind == "string":
                default = ""
            elif kind == "bytes":
                default = b""
            elif kind == "bool":
                default = False
            elif kind == "double":
                default = 0.0
            else:
                default = 0
            setattr(self, name, kwargs.pop(name, default))
        if kwargs:
            raise TypeError(f"unknown fields {sorted(kwargs)} for {type(self).__name__}")

    # -- encoding ---------------------------------------------------------

    def encode(self) -> bytes:
        out = bytearray()
        for number, name, kind in self.FIELDS:
            value = getattr(self, name)
            repeated = isinstance(kind, list)
            k = kind[0] if repeated else kind
            if k == "msg_self":
                k = type(self)
            values = value if repeated else [value]
            for v in values:
                if isinstance(k, type):
                    if v is None:
                        continue
                    payload = v.encode()
                    if not payload and not repeated:
                        # present-but-empty submessage still serializes
                        # as zero-length; we treat None as absent.
                        pass
                    out += wire.encode_tag(number, wire.LENGTH_DELIMITED)
                    out += wire.encode_varint(len(payload))
                    out += payload
                elif k == "string":
                    if not v and not repeated:
                        continue
                    raw = v.encode("utf-8") if isinstance(v, str) else v
                    out += wire.encode_tag(number, wire.LENGTH_DELIMITED)
                    out += wire.encode_varint(len(raw))
                    out += raw
                elif k == "bytes":
                    if not v and not repeated:
                        continue
                    out += wire.encode_tag(number, wire.LENGTH_DELIMITED)
                    out += wire.encode_varint(len(v))
                    out += v
                elif k in ("int", "uint"):
                    if not v and not repeated:
                        continue
                    out += wire.encode_tag(number, wire.VARINT)
                    out += wire.encode_varint(v)
                elif k == "sint":
                    if not v and not repeated:
                        continue
                    out += wire.encode_tag(number, wire.VARINT)
                    out += wire.encode_zigzag(v)
                elif k == "bool":
                    if not v and not repeated:
                        continue
                    out += wire.encode_tag(number, wire.VARINT)
                    out += wire.encode_varint(1 if v else 0)
                elif k == "double":
                    if not v and not repeated:
                        continue
                    out += wire.encode_tag(number, wire.FIXED64)
                    out += wire.encode_double(v)
                else:  # pragma: no cover
                    raise TypeError(f"bad field kind {k!r}")
        return bytes(out)

    # -- decoding ---------------------------------------------------------

    @classmethod
    def decode(cls, data: bytes, pos: int = 0, end: int | None = None):
        if end is None:
            end = len(data)
        self = cls()
        fields = cls._field_map()
        while pos < end:
            tag, pos = wire.decode_varint(data, pos)
            number, wt = tag >> 3, tag & 7
            entry = fields.get(number)
            if entry is None:
                pos = wire.skip_field(data, pos, wt)
                continue
            name, kind = entry
            repeated = isinstance(kind, list)
            k = kind[0] if repeated else kind
            if k == "msg_self":
                k = cls
            if isinstance(k, type):
                size, pos = wire.decode_varint(data, pos)
                v = k.decode(data, pos, pos + size)
                pos += size
            elif k in ("string", "bytes"):
                size, pos = wire.decode_varint(data, pos)
                raw = data[pos : pos + size]
                pos += size
                v = raw.decode("utf-8") if k == "string" else bytes(raw)
            elif k == "int":
                v, pos = wire.decode_signed_varint(data, pos)
            elif k == "uint":
                if wt == wire.LENGTH_DELIMITED:  # packed repeated
                    size, pos = wire.decode_varint(data, pos)
                    stop = pos + size
                    lst = getattr(self, name)
                    while pos < stop:
                        v, pos = wire.decode_varint(data, pos)
                        lst.append(v)
                    continue
                v, pos = wire.decode_varint(data, pos)
            elif k == "sint":
                v, pos = wire.decode_zigzag(data, pos)
            elif k == "bool":
                v, pos = wire.decode_varint(data, pos)
                v = bool(v)
            elif k == "double":
                if wt == wire.LENGTH_DELIMITED:  # packed repeated
                    size, pos = wire.decode_varint(data, pos)
                    stop = pos + size
                    lst = getattr(self, name)
                    while pos < stop:
                        v, pos = wire.decode_double(data, pos)
                        lst.append(v)
                    continue
                v, pos = wire.decode_double(data, pos)
            else:  # pragma: no cover
                raise TypeError(f"bad field kind {k!r}")
            if repeated:
                getattr(self, name).append(v)
            else:
                setattr(self, name, v)
        return self

    @classmethod
    def _field_map(cls):
        cached = cls.__dict__.get("_FIELD_MAP")
        if cached is None:
            cached = {num: (name, kind) for num, name, kind in cls.FIELDS}
            cls._FIELD_MAP = cached
        return cached

    # -- utilities --------------------------------------------------------

    def __eq__(self, other):
        if type(self) is not type(other):
            return NotImplemented
        return all(
            getattr(self, name) == getattr(other, name) for _, name, _ in self.FIELDS
        )

    def __repr__(self):
        parts = []
        for _, name, kind in self.FIELDS:
            v = getattr(self, name)
            if v in (None, "", b"", 0, 0.0, False) or v == []:
                continue
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _slots(fields):
    return tuple(name for _, name, _ in fields)


class Edit(Message):
    FIELDS = (
        (1, "from_length", "int"),
        (2, "to_length", "int"),
        (3, "sequence", "string"),
    )
    __slots__ = _slots(FIELDS)


class Position(Message):
    FIELDS = (
        (1, "node_id", "int"),
        (2, "offset", "int"),
        (4, "is_reverse", "bool"),
        (5, "name", "string"),
    )
    __slots__ = _slots(FIELDS)


class Mapping(Message):
    FIELDS = ((1, "position", Position), (2, "edit", [Edit]), (5, "rank", "int"))
    __slots__ = _slots(FIELDS)


class Path(Message):
    FIELDS = (
        (1, "name", "string"),
        (2, "mapping", [Mapping]),
        (3, "is_circular", "bool"),
        (4, "length", "int"),
    )
    __slots__ = _slots(FIELDS)


class Support(Message):
    FIELDS = (
        (1, "quality", "double"),
        (2, "forward", "double"),
        (3, "reverse", "double"),
        (4, "left", "double"),
        (5, "right", "double"),
    )
    __slots__ = _slots(FIELDS)


class Genotype(Message):
    FIELDS = (
        (1, "allele", ["int"]),
        (2, "is_phased", "bool"),
        (3, "likelihood", "double"),
        (4, "log_likelihood", "double"),
        (5, "log_prior", "double"),
        (6, "log_posterior", "double"),
    )
    __slots__ = _slots(FIELDS)


class Locus(Message):
    FIELDS = (
        (1, "name", "string"),
        (2, "allele", [Path]),
        (3, "support", [Support]),
        (4, "genotype", [Genotype]),
        (5, "overall_support", Support),
        (6, "allele_log_likelihood", ["double"]),
    )
    __slots__ = _slots(FIELDS)


class Alignment(Message):
    FIELDS = (
        (1, "sequence", "string"),
        (2, "path", Path),
        (3, "name", "string"),
        (4, "quality", "bytes"),
        (5, "mapping_quality", "int"),
        (6, "score", "int"),
        (7, "query_position", "int"),
        (9, "sample_name", "string"),
        (10, "read_group", "string"),
        (11, "fragment_prev", "msg_self"),
        (12, "fragment_next", "msg_self"),
        (15, "is_secondary", "bool"),
        (16, "identity", "double"),
        (17, "fragment", [Path]),
        (18, "locus", [Locus]),
        (19, "refpos", [Position]),
        (20, "read_paired", "bool"),
        (21, "read_mapped", "bool"),
        (22, "mate_unmapped", "bool"),
        (23, "read_on_reverse_strand", "bool"),
        (24, "mate_on_reverse_strand", "bool"),
        (25, "soft_clipped", "bool"),
        (26, "discordant_insert_size", "bool"),
        (27, "uniqueness", "double"),
    )
    __slots__ = _slots(FIELDS)


# -- fast constructors ------------------------------------------------------
# The generic Message.__init__ walks FIELDS with isinstance checks per
# call; alignment output builds ~500 messages per read, making it a
# measurable share of pipeline time. Compile a specialized __init__ per
# class (one assignment per field) once at import.
_MISSING = object()


def _compile_init(cls):
    names = [name for _, name, _ in cls.FIELDS]
    sig = ", ".join(f"{n}=_MISSING" for n in names)
    lines = [f"def __init__(self, {sig}):"]
    for _, name, kind in cls.FIELDS:
        if isinstance(kind, list):
            default = "[]"
        elif isinstance(kind, type) or (
            isinstance(kind, str) and kind.startswith("msg_self")
        ):
            default = "None"
        elif kind == "string":
            default = "''"
        elif kind == "bytes":
            default = "b''"
        elif kind == "bool":
            default = "False"
        elif kind == "double":
            default = "0.0"
        else:
            default = "0"
        lines.append(
            f"    self.{name} = {default} if {name} is _MISSING else {name}"
        )
    if not cls.FIELDS:
        lines.append("    pass")
    ns = {"_MISSING": _MISSING}
    exec("\n".join(lines), ns)
    cls.__init__ = ns["__init__"]


for _cls in list(Message.__subclasses__()):
    _compile_init(_cls)
