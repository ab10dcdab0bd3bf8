"""Readers of the program's output files (xz FASTA and CSV), for the
checks.  The program writes an .xz file as a run of independent xz
streams; they are decompressed on a few threads."""

from __future__ import annotations

import lzma
from concurrent.futures import ThreadPoolExecutor

_MAGIC = b"\xfd7zXZ\x00"


def _streams(data: bytes) -> list[bytes]:
    """The file cut at every xz stream header (a piece that does not
    decompress alone is joined to the next)."""
    starts = []
    i = data.find(_MAGIC)
    while i >= 0:
        starts.append(i)
        i = data.find(_MAGIC, i + 1)
    if not starts or starts[0] != 0:
        return [data]
    return [data[a:b] for a, b in zip(starts, starts[1:] + [len(data)])]


def _one(piece: bytes):
    try:
        return lzma.decompress(piece)
    except lzma.LZMAError:
        return None


def unxz(path, workers: int = 8) -> bytes:
    with open(path, "rb") as fh:
        data = fh.read()
    if not data:
        return b""
    pieces = _streams(data)
    with ThreadPoolExecutor(workers) as ex:
        out = list(ex.map(_one, pieces))
    if any(o is None for o in out):          # a header inside a stream
        return lzma.decompress(data)
    return b"".join(out)


def fasta_records(path) -> list[tuple[str, bytes]]:
    """(name, sequence) of every record of an xz FASTA file."""
    text = unxz(path)
    out = []
    for rec in text.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        out.append((head.decode(), body.replace(b"\n", b"")))
    return out


def csv_rows(path) -> tuple[str, list[list[str]]]:
    """(header, rows) of an xz CSV file."""
    lines = unxz(path).decode().split("\n")
    return lines[0], [ln.split(",") for ln in lines[1:] if ln]
