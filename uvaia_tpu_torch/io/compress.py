"""Compressed stream helpers (xz/gz/bz2/raw): the port's copy of
``uvaia_tpu/io/compress.py``.

Mirrors biomcmc-lib's ``file_compress_t`` behaviour used by the
reference (autodetect by magic bytes on read — fastaseq.c:414; choose
codec for writing — nearest.c:234-236): reading sniffs the first bytes,
writing picks the codec from the filename suffix (xz preferred, like the
reference's "tries in order xz, bz, gz, raw").
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
from pathlib import Path

_MAGIC = [
    (b"\xfd7zXZ\x00", "xz"),
    (b"\x1f\x8b", "gz"),
    (b"BZh", "bz2"),
]


def sniff_codec(path: str | Path) -> str:
    with open(path, "rb") as f:
        head = f.read(6)
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    return "raw"


def open_read(path: str | Path) -> io.BufferedReader:
    """Open a possibly-compressed file for buffered binary reading."""
    codec = sniff_codec(path)
    if codec == "xz":
        return io.BufferedReader(lzma.open(path, "rb"), buffer_size=1 << 20)
    if codec == "gz":
        return io.BufferedReader(gzip.open(path, "rb"), buffer_size=1 << 20)
    if codec == "bz2":
        return io.BufferedReader(bz2.open(path, "rb"), buffer_size=1 << 20)
    return open(path, "rb", buffering=1 << 20)


def open_write(path: str | Path, preset: int = 6,
               append: bool = False) -> io.BufferedWriter:
    """Open a file for binary writing, codec chosen by suffix.

    Append mode starts a fresh compressed stream at the end of the
    file; xz/gz/bz2 readers all accept such concatenated streams, so
    checkpointed scans can extend their dump across restarts."""
    name = str(path)
    mode = "ab" if append else "wb"
    if name.endswith(".xz"):
        return lzma.open(name, mode, preset=preset)
    if name.endswith(".gz"):
        return gzip.open(name, mode, compresslevel=preset)
    if name.endswith(".bz2"):
        return bz2.open(name, mode, compresslevel=preset)
    return open(name, mode)
