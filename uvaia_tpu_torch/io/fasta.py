"""Streaming FASTA reader/writer over possibly-compressed files: the
port's copy of ``uvaia_tpu/io/fasta.py`` (same records, same output
bytes), reading through the port's own native library (io/native.py).

Behavioural contract copied from the reference's incremental reader
(``readfasta_next``, src/fastaseq.c:410-486): multi-line sequences are
accumulated, spaces stripped, characters uppercased; the header name is
the full rest of the ``>`` line.  Unlike the C version this reader is a
generator; batching lives in the engine layer.
"""

from __future__ import annotations

import lzma
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from .compress import open_read, open_write

# Uppercase ASCII a-z; other bytes unchanged. Spaces/tabs deleted.
_UPPER = bytes(c - 32 if 97 <= c <= 122 else c for c in range(256))
_DELETE = b" \t\r"


@dataclass
class FastaRecord:
    name: str
    seq: bytes  # uppercased, space-free


def read_fasta(path: str | Path) -> Iterator[FastaRecord]:
    """Yield (name, uppercased sequence bytes) records.

    Uses the native C++ reader (io/native.py) for xz/gz/raw files,
    falling back to the Python implementation (bz2, a codec the native
    library was built without, or no native library)."""
    from .compress import sniff_codec
    if sniff_codec(path) != "bz2":
        yielded = False
        try:
            from .native import read_fasta_native
            for name, seq in read_fasta_native(path):
                yielded = True
                yield FastaRecord(name, seq)
            return
        except RuntimeError:
            # fall back ONLY when the native reader could not start: a
            # mid-stream error (truncated/corrupt file) after records
            # were already emitted must surface — restarting with the
            # Python reader would silently duplicate the emitted head
            if yielded:
                raise
    yield from _read_fasta_py(path)


def _read_fasta_py(path: str | Path) -> Iterator[FastaRecord]:
    name: str | None = None
    chunks: list[bytes] = []
    with open_read(path) as fh:
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            gt = line.find(b">")
            if gt >= 0:
                if name is not None:
                    yield FastaRecord(name, b"".join(chunks))
                name = line[gt + 1:].decode("utf-8", errors="replace")
                chunks = []
            elif name is not None:
                chunks.append(line.translate(_UPPER, _DELETE))
    if name is not None:
        yield FastaRecord(name, b"".join(chunks))


def read_fasta_all(path: str | Path) -> list[FastaRecord]:
    return list(read_fasta(path))


class FastaWriter:
    """Append-style FASTA writer to a (possibly xz-compressed) stream.

    Mirrors ``save_sequence_to_compress_stream`` (nearest.c:416-426).
    For high-volume xz output the engines use ParallelXzFastaWriter
    below; this plain writer serves the low-volume paths (legacy tool,
    arbitrary-codec outputs).
    """

    def __init__(self, path: str | Path, preset: int = 6,
                 append: bool = False):
        self.path = str(path)
        self._fh = open_write(path, preset=preset, append=append)
        self.n_written = 0

    def write(self, name: str, seq: bytes | str) -> None:
        if isinstance(seq, str):
            seq = seq.encode("ascii")
        self._fh.write(b">" + name.encode("utf-8") + b"\n" + seq + b"\n")
        self.n_written += 1

    def write_compressed(self, frame: bytes) -> None:
        """Append a store dump frame (a complete xz stream holding one
        ``>name\\nseq\\n`` record, io/store.py frame_row).  A non-xz
        --codec writer cannot splice the frame verbatim, so it decodes
        and re-encodes through its own stream — only the xz writer
        (ParallelXzFastaWriter) gets the zero-work pass-through."""
        self._fh.write(lzma.decompress(frame))
        self.n_written += 1

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


#: writer codecs selectable by the engines' --codec flag.  The
#: reference's biomcmc_open_compress picks the best available codec in
#: order xz, bz2, gz, raw (nearest.c:234-236 comment); every codec is
#: available here, so the flag exposes the same choice explicitly
#: instead of by library absence.
WRITE_CODEC_SUFFIX = {"xz": ".xz", "bz2": ".bz2", "gz": ".gz", "raw": ""}


def make_fasta_writer(base: str, codec: str = "xz", append: bool = False):
    """FASTA dump writer for ``<base>.<codec suffix>``: the parallel
    chunked writer for xz (the high-volume default), the plain
    suffix-dispatched writer (io/compress.open_write) otherwise."""
    try:
        suffix = WRITE_CODEC_SUFFIX[codec]
    except KeyError:
        raise ValueError(f"unknown output codec {codec!r} "
                         f"(choose from {sorted(WRITE_CODEC_SUFFIX)})")
    if codec == "xz":
        return ParallelXzFastaWriter(base + suffix, append=append)
    return FastaWriter(base + suffix, append=append)


#: default filter chain for genome batches: aligned genomes in one
#: stream are ~99.9% mutual matches, so a hash-chain match finder with
#: maximal nice_len and a 4MB dict (covers a whole chunk) beats preset
#: 1 on BOTH axes — measured on the real DB at 1MB chunks: 0.69 vs
#: 0.78 ms/row and 0.51 vs 2.29 KB/row (preset 1).  Still plain
#: FORMAT_XZ streams: any xz reader accepts them.
_GENOME_FILTERS = [{"id": lzma.FILTER_LZMA2, "dict_size": 4 << 20,
                    "mode": lzma.MODE_FAST, "nice_len": 273,
                    "mf": lzma.MF_HC4, "depth": 0}]


class ParallelXzFastaWriter:
    """FASTA writer that compresses record chunks as independent xz
    streams on a thread pool and concatenates them in order.

    ``LZMACompressor`` releases the GIL, so ~1MB chunks compressed on
    a few worker threads give near-linear speedup of the xz drain that
    otherwise serialises after the last batch (measured: 0.44s of a
    0.93s 256-genome align run was the single-threaded xz close).
    Concatenated xz streams are exactly what the checkpoint append
    path already writes (compress.open_write); every xz reader accepts
    them.

    ``preset=None`` (the default) selects the genome filter chain
    above; pass an integer preset for non-genome payloads.
    """

    def __init__(self, path: str | Path, preset: int | None = None,
                 chunk: int = 1 << 22, workers: int | None = None,
                 append: bool = False):
        import concurrent.futures as cf
        import os
        self.path = str(path)
        if not self.path.endswith(".xz"):
            raise ValueError("ParallelXzFastaWriter requires a .xz path")
        # append is sound by construction: every prior close() left the
        # file as a whole number of complete xz streams
        self._fh = open(self.path, "ab" if append else "wb")
        self.n_written = 0
        self._buf: list[bytes] = []
        self._sz = 0
        self._chunk = chunk
        self._preset = preset
        self._workers = workers or min(8, os.cpu_count() or 4)
        self._pool = cf.ThreadPoolExecutor(max_workers=self._workers)
        from collections import deque
        self._futs = deque()

    def _submit(self) -> None:
        data = b"".join(self._buf)
        self._buf = []
        self._sz = 0
        kw = ({"filters": _GENOME_FILTERS} if self._preset is None
              else {"preset": self._preset})
        self._futs.append(self._pool.submit(
            lzma.compress, data, format=lzma.FORMAT_XZ, **kw))

    def _drain(self, block: bool) -> None:
        while self._futs and (block or self._futs[0].done()):
            self._fh.write(self._futs.popleft().result())

    def write(self, name: str, seq: bytes | str) -> None:
        if isinstance(seq, str):
            seq = seq.encode("ascii")
        self._buf.append(b">" + name.encode("utf-8") + b"\n" + seq + b"\n")
        self._sz += len(self._buf[-1])
        self.n_written += 1
        if self._sz >= self._chunk:
            self._submit()
            # bound in-flight chunks so memory stays ~workers x chunk;
            # block on the OLDEST future only — draining the whole
            # queue would stall the producer for a full pipeline depth
            while len(self._futs) > 2 * self._workers:
                self._fh.write(self._futs.popleft().result())
            self._drain(block=False)

    def write_compressed(self, frame: bytes) -> None:
        """Append one record that is ALREADY a complete xz stream (the
        store's pre-compressed dump frames, io/store.py): buffered
        records are flushed first as their own stream so record order
        is preserved, then the frame rides the queue as a resolved
        future — zero compression work at scan time."""
        import concurrent.futures as cf
        if self._buf:
            self._submit()
        f: cf.Future = cf.Future()
        f.set_result(frame)
        self._futs.append(f)
        self.n_written += 1
        self._drain(block=False)

    def close(self) -> None:
        if self._buf:
            self._submit()
        self._drain(block=True)
        self._pool.shutdown()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
