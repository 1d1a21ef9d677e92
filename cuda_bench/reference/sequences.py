# Frozen copy of graphaligner_tpu_torch/io/sequences.py, part of the benchmark's plain reference (imports nothing of the program).
"""IUPAC-aware sequence utilities (reference: CommonUtils.cpp:60-136).

The complement table matches the reference's switch statement, including
uppercasing of lowercase input and U→A. The reference's 'H' case falls
through to an assert by accident; here H→D as IUPAC intends (the NDEBUG
reference build behaves the same way).
"""

from __future__ import annotations

_COMPLEMENT = {
    "A": "T", "a": "T",
    "C": "G", "c": "G",
    "T": "A", "t": "A",
    "G": "C", "g": "C",
    "N": "N", "n": "N",
    "U": "A", "u": "A",
    "R": "Y", "r": "Y",
    "Y": "R", "y": "R",
    "K": "M", "k": "M",
    "M": "K", "m": "K",
    "S": "S", "s": "S",
    "W": "W", "w": "W",
    "B": "V", "b": "V",
    "V": "B", "v": "B",
    "D": "H", "d": "H",
    "H": "D", "h": "D",
}

_RC_TABLE = str.maketrans(_COMPLEMENT)


def reverse_complement(seq: str) -> str:
    """IUPAC reverse complement; raises KeyError on non-IUPAC characters."""
    bad = set(seq) - _COMPLEMENT.keys()
    if bad:
        raise ValueError(f"non-IUPAC characters in sequence: {sorted(bad)}")
    return seq.translate(_RC_TABLE)[::-1]


# Degenerate-base match sets for the *read* side (reference:
# GraphAligner.h:2039-2110 characterMatch). Graph characters are strictly
# ACGT; read characters may be IUPAC degenerate codes; 'N' matches all.
IUPAC_MATCHES = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT",
    "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG",
    "N": "ACGT",
}


def characters_match(seq_char: str, graph_char: str) -> bool:
    """Unit-cost match predicate: IUPAC read char vs ACGT graph char."""
    if graph_char not in "ACGT":
        raise ValueError(f"graph character must be ACGT, got {graph_char!r}")
    matches = IUPAC_MATCHES.get(seq_char.upper())
    if matches is None:
        raise ValueError(f"unsupported read character {seq_char!r}")
    return graph_char in matches
