"""Nucleotide encoding: the port's copy of ``uvaia_tpu/core/encoding.py``
(the same tables, byte for byte, so both packages encode alike).

Every sequence character is mapped to a 4-bit IUPAC *base-mask* over
{A=1, C=2, G=4, T=8}; the mask value itself is the character's code
(``A=1, C=2, M=3, G=4, R=5, S=6, V=7, T=8, W=9, Y=10, H=11, K=12, D=13,
B=14``).  Code ``0`` marks an *invalid* site: fully ambiguous or gap-like
characters, i.e. the reference's ``is_indel`` set ``{N,n,X,x,-,?,O,o,.}``
(reference: src/utils.c:255-264) plus any unrecognised character.

From a pair of codes the four match counters of the reference's scoring
contract follow (reference: src/utils.c:266-295 and README.md:254-330):

* ``valid_pair``      —  ``c1 != 0 and c2 != 0``
* ``acgt_match``      —  both pure bases (popcount==1) and equal
* ``text_match``      —  ``c1 == c2 != 0`` (character equality)
* ``partial_match``   —  ``c1 & c2 != 0`` (IUPAC sets intersect; N is
  already excluded because its code is 0)

Known deviations from the C reference, all documented and benign for
DNA alignments:

* ``U``/``u`` is encoded as ``T`` (mask 8).  The C code treats ``U`` as an
  opaque valid character, so ``U`` vs ``T`` would not *text*-match there.
* Unrecognised characters (e.g. ``Z``) are invalid here; the C code
  treats anything outside ``is_indel`` as a valid opaque character.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 1, 2, 4, 8

# IUPAC base masks.
_MASKS = {
    "A": A, "C": C, "G": G, "T": T, "U": T,
    "R": A | G, "Y": C | T, "S": C | G, "W": A | T,
    "K": G | T, "M": A | C,
    "B": C | G | T, "D": A | G | T, "H": A | C | T, "V": A | C | G,
}

#: 256-entry char -> code lookup (uint8), upper/lowercase both mapped.
ENCODE_LUT = np.zeros(256, dtype=np.uint8)
for _ch, _m in _MASKS.items():
    ENCODE_LUT[ord(_ch)] = _m
    ENCODE_LUT[ord(_ch.lower())] = _m

#: code -> canonical character (code 0 -> 'N').
DECODE_LUT = np.full(16, ord("N"), dtype=np.uint8)
for _ch, _m in _MASKS.items():
    if _ch != "U":
        DECODE_LUT[_m] = ord(_ch)

#: popcount of the 4-bit code.
POPCOUNT4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.uint8)

#: pure base indicator (exactly one bit set).
IS_PURE = (POPCOUNT4 == 1).astype(np.uint8)

#: ambiguity code indicator (valid but not a pure base).
IS_AMBIG = ((np.arange(16) != 0) & (POPCOUNT4 != 1)).astype(np.uint8)


#: characters with DEFINED semantics here: IUPAC codes (either case)
#: plus the reference's is_indel set {N,n,X,x,-,?,O,o,.}
#: (src/utils.c:258-264).  Anything else is where this implementation
#: deviates from the C: the C treats such bytes as opaque VALID
#: characters (they can text-match and count as valid pairs), we map
#: them to invalid (code 0).  Benign for DNA FASTA — the bundled real
#: data contains zero such bytes — but real on dirty inputs, so the QC
#: paths surface it via UVAIA_TPU_STRICT_CHARS=warn|error.
RECOGNISED = np.zeros(256, dtype=bool)
for _ch in _MASKS:
    RECOGNISED[ord(_ch)] = RECOGNISED[ord(_ch.lower())] = True
for _ch in b"NnXx-?Oo.":
    RECOGNISED[_ch] = True


def count_unrecognised(seq: bytes | np.ndarray) -> int:
    """Number of bytes outside the defined IUPAC + indel alphabet —
    exactly the bytes whose validity semantics deviate from the C
    reference (opaque-valid there, invalid here)."""
    buf = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) \
        else seq
    return int((~RECOGNISED[buf]).sum())


def strict_chars_check(name: str, seq: bytes | np.ndarray) -> None:
    """Dirty-input guard: with UVAIA_TPU_STRICT_CHARS=warn (or error),
    report sequences carrying unrecognised characters instead of
    silently scoring them as invalid sites (the C would text-match
    them as opaque characters — utils.c:258-264)."""
    import os
    import sys
    mode = os.environ.get("UVAIA_TPU_STRICT_CHARS", "").strip().lower()
    if not mode or mode in ("0", "off", "false"):
        return
    n = count_unrecognised(seq)
    if not n:
        return
    msg = (f"Sequence {name} carries {n} unrecognised character(s) "
           f"(outside IUPAC + {{N,X,-,?,O,.}}): treated as invalid "
           f"sites here, but the C reference text-matches them as "
           f"opaque characters")
    if mode == "warn":
        print(msg, file=sys.stderr, flush=True)
        return
    # any other truthy value ("error", "ERROR", "1", "strict", ...)
    # fails CLOSED: a user who set a strictness knob must never get a
    # silent downgrade to warn because of spelling
    raise SystemExit(msg)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """Encode a sequence into uint8 codes (0..14)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    buf = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return ENCODE_LUT[buf]


def composition(codes: np.ndarray) -> tuple[float, float, float]:
    """(ACGT fraction, partially-ambiguous fraction, N/gap/other fraction).

    Mirrors ``biomcmc_count_sequence_acgt`` as used for QC thresholds
    (reference: src/utils.c:22-31, src/align.c:194-202).
    """
    n = len(codes)
    if n == 0:
        return 0.0, 0.0, 1.0
    acgt = IS_PURE[codes].sum() / n
    amb = IS_AMBIG[codes].sum() / n
    return float(acgt), float(amb), float(1.0 - acgt - amb)
