"""Host-side streaming for the port's scans.

``RefBatch``, ``dump_entry``, ``write_dump``, ``StreamStats`` and
``RefStreamer`` are the port's copies of ``uvaia_tpu/engine/stream.py``'s
(a background reader thread feeding fixed-shape encoded batches through
a bounded queue, the native reader's batched API on the fast path);
:class:`EncodedStream` is the counterpart of its encode stage, encoding
with the port's jax-free host module (ops/host.py).  The native reader
takes every file whose codec the port's library was built with; the
others (bz2 always, xz where the machine has no liblzma) go through
the Python reader.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field

import numpy as np

from ..core.encoding import ENCODE_LUT, RECOGNISED, strict_chars_check
from ..io import native
from ..io.compress import sniff_codec
from ..io.fasta import read_fasta
from ..ops import host
from ..utils.prefetch import Prefetcher, ordered_pool_map

__all__ = ["EncodedStream", "RefBatch", "RefStreamer", "StreamStats",
           "dump_entry", "write_dump"]


@dataclass
class RefBatch:
    codes: np.ndarray          # (B, L) uint8, zero-padded rows
    ok: np.ndarray             # (B,) bool
    names: list[str]           # len n (valid rows only)
    base_idx: int              # global index of row 0
    n: int                     # number of valid rows
    raw: np.ndarray | None = None      # (n, L) raw chars (native path)
    seqs: list[bytes] | None = None    # python path
    # exact stream position after this batch's last record — lets a
    # checkpoint resume precisely here
    records_read: int = 0
    n_invalid: int = 0
    same_name: int = 0

    def seq(self, i: int) -> bytes:
        if self.seqs is not None:
            return self.seqs[i]
        return self.raw[i].tobytes()

    def frame(self, i: int):
        """No pre-compressed dump frame on the FASTA path (store
        batches override this — see io/store.StoreBatch.frame)."""
        return None


def dump_entry(batch, i: int):
    """(name, seq-or-None, frame-or-None) for dump-writer retention:
    store batches carry pre-compressed frames, FASTA batches raw
    bytes."""
    frame = batch.frame(i)
    if frame is not None:
        return (batch.names[i], None, frame)
    return (batch.names[i], batch.seq(i), None)


def write_dump(writer, entry) -> None:
    """Write a dump_entry through a FASTA dump writer (both writer
    classes implement write_compressed: the xz writer splices the
    pre-compressed frame verbatim, a --codec writer re-encodes it)."""
    name, seq, frame = entry
    if frame is not None:
        writer.write_compressed(frame)
    else:
        writer.write(name, seq)


@dataclass
class StreamStats:
    count: int = 0             # sequences read (incl. rejected-by-quality)
    n_invalid: int = 0         # rejected: too ambiguous
    same_name: int = 0         # rejected: name present in query set
    files: list[str] = field(default_factory=list)


class RefStreamer:
    """Reads aligned reference files into encoded batches.

    QC mirrors nearest.c:250-286: skip same-name refs (--exclude_self),
    skip refs with fewer than (1-ref_ambiguity)*L valid sites, error on
    length mismatch.
    """

    def __init__(self, paths: list[str], n_sites: int, batch: int,
                 ref_ambiguity: float = 0.5,
                 exclude_names: set[str] | None = None,
                 prefetch: int = 4,
                 skip_records: int = 0, initial_base: int = 0):
        self.paths = paths
        self.n_sites = n_sites
        self.batch = batch
        self.min_valid = int(n_sites * (1.0 - ref_ambiguity))
        self.exclude_names = exclude_names or set()
        self.skip_records = skip_records   # resume: raw records to skip
        self.initial_base = initial_base   # resume: accepted-count offset
        self.stats = StreamStats()
        self._pf = Prefetcher(self._batches, maxsize=prefetch)

    def __iter__(self):
        return iter(self._pf)

    # ------------------------------------------------------------------

    def _records(self):
        """Yield (names, raw_chars (k, L), codes-or-None,
        valid-counts-or-None) chunks."""
        lib = native.get_lib()
        natively = {"raw", *native.codecs(lib)} if lib is not None else ()
        for path in self.paths:
            self.stats.files.append(path)
            if sniff_codec(path) in natively:
                yield from self._native_chunks(lib, path)
            else:
                yield from self._python_chunks(path)

    def _native_chunks(self, lib, path):
        L, chunk = self.n_sites, self.batch
        handle = lib.ufa_open(str(path).encode())
        if not handle:
            raise SystemExit(f"cannot open reference file {path}")
        namecap = 1024 * chunk
        namebuf = ctypes.create_string_buffer(namecap)
        ends = (ctypes.c_long * chunk)()
        lens = (ctypes.c_long * chunk)()
        valid = (ctypes.c_long * chunk)()
        lut = ENCODE_LUT.tobytes()
        try:
            while True:
                # np.empty, not zeros: the reader overwrites rows
                # [0, k) completely (aligned input, len == stride) and
                # the [k:] tail is sliced off before leaving here —
                # memset of 2 x 122MB/batch dominated the streamer on
                # low-bandwidth hosts
                raw = np.empty((chunk, L), dtype=np.uint8)
                codes = np.empty((chunk, L), dtype=np.uint8)
                k = lib.ufa_next_batch(
                    handle, raw.ctypes.data_as(ctypes.c_void_p),
                    codes.ctypes.data_as(ctypes.c_void_p), lut, L, chunk,
                    namebuf, namecap, ends, lens, valid)
                if k < 0:
                    raise SystemExit(f"error reading {path}")
                if k == 0:
                    return
                blob = namebuf.raw
                names, start = [], 0
                for i in range(k):
                    names.append(blob[start:ends[i]].decode(
                        "utf-8", errors="replace"))
                    start = ends[i]
                for i in range(k):
                    if lens[i] != L:
                        raise SystemExit(
                            f"Reference sequence '{names[i]}' has "
                            f"{lens[i]} sites but query sequences have "
                            f"{L} sites: all sequences must be aligned")
                yield (names, raw[:k], codes[:k],
                       np.asarray(valid[:k], dtype=np.int64))
        finally:
            lib.ufa_close(handle)

    def _python_chunks(self, path):
        L = self.n_sites
        names, rows = [], []
        for rec in read_fasta(path):
            if len(rec.seq) != L:
                raise SystemExit(
                    f"Reference sequence '{rec.name}' has {len(rec.seq)} "
                    f"sites but query sequences have {L} sites: all "
                    "sequences must be aligned")
            names.append(rec.name)
            rows.append(np.frombuffer(rec.seq, dtype=np.uint8))
            if len(names) >= self.batch:
                yield names, np.stack(rows), None, None
                names, rows = [], []
        if names:
            yield names, np.stack(rows), None, None

    # ------------------------------------------------------------------

    def _batches(self):
        """Generator run on the Prefetcher's thread."""
        base = self.initial_base
        skip = self.skip_records
        acc_names: list[str] = []
        acc_codes = np.zeros((self.batch, self.n_sites), dtype=np.uint8)
        acc_raw = np.zeros((self.batch, self.n_sites), dtype=np.uint8)
        n = 0

        def mk(codes, ok, names, count, raw):
            nonlocal base
            b = RefBatch(codes, ok, names, base, count, raw=raw,
                         records_read=self.stats.count,
                         n_invalid=self.stats.n_invalid,
                         same_name=self.stats.same_name)
            base += count
            return b

        for names, raw, codes, valid in self._records():
            if skip:                     # resume: fast-skip records
                if skip >= len(names):
                    skip -= len(names)
                    continue
                names = names[skip:]
                raw = raw[skip:]
                codes = None if codes is None else codes[skip:]
                valid = None if valid is None else valid[skip:]
                skip = 0
            if codes is None:
                codes = ENCODE_LUT[raw]
            if valid is None:
                valid = (codes != 0).sum(axis=1)
            if os.environ.get("UVAIA_TPU_STRICT_CHARS"):
                # dirty-input guard on the reference side too: one
                # vectorised LUT reduction per chunk (off by default so
                # the hot path pays nothing; per-row work only for the
                # offending rows)
                bad = (~RECOGNISED[raw]).any(axis=1)
                for i in np.nonzero(bad)[0]:
                    strict_chars_check(names[int(i)], raw[int(i)])
            keep = valid >= self.min_valid
            excl = None
            if self.exclude_names:
                # name exclusion precedes the quality check, as in
                # nearest.c:255-270
                excl = np.array([nm in self.exclude_names
                                 for nm in names])
                keep &= ~excl
            if n == 0 and len(names) == self.batch and keep.all():
                # common fast path: full clean chunk, no copies
                self.stats.count += self.batch
                yield mk(codes, np.ones(self.batch, dtype=bool), names,
                         self.batch, raw)
                continue
            for i in range(len(names)):
                self.stats.count += 1
                if not keep[i]:
                    if excl is not None and excl[i]:
                        self.stats.same_name += 1
                    else:
                        self.stats.n_invalid += 1
                    continue
                acc_codes[n] = codes[i]
                acc_raw[n] = raw[i]
                acc_names.append(names[i])
                n += 1
                if n == self.batch:
                    yield mk(acc_codes, np.ones(self.batch, dtype=bool),
                             acc_names, n, acc_raw)
                    acc_names, n = [], 0
                    acc_codes = np.zeros_like(acc_codes)
                    acc_raw = np.zeros_like(acc_raw)
        if n:
            ok = np.zeros(self.batch, dtype=bool)
            ok[:n] = True
            yield mk(acc_codes, ok, acc_names, n, acc_raw)


class EncodedStream:
    """Host-encode batches on a worker pool, yielding (batch, payload)
    in order: ("delta", pos, val) when the sparse diff fits the
    buckets, else ("packed", packed).  Batches i+1..i+workers encode
    while batch i's upload and device step run.  ``workers``
    (UVAIA_TPU_ENCODE_THREADS) defaults to min(2, cpu_count - 1),
    floor 1, as in the JAX package."""

    def __init__(self, streamer: RefStreamer, delta_base: np.ndarray,
                 prefetch: int = 2, workers: int | None = None):
        self.streamer = streamer
        self.delta_base = delta_base
        if workers is None:
            workers = int(os.environ.get(
                "UVAIA_TPU_ENCODE_THREADS",
                max(1, min(2, (os.cpu_count() or 1) - 1))))
        self._workers = max(1, workers)
        self._pf = Prefetcher(self._batches,
                              maxsize=max(prefetch, self._workers))

    def _encode(self, batch):
        enc = host.delta_encode(batch.codes, batch.ok, self.delta_base)
        if enc is not None:
            return batch, ("delta", enc[0], enc[1])
        return batch, ("packed", host.pack_codes(batch.codes))

    def _batches(self):
        yield from ordered_pool_map(self._encode, self.streamer,
                                    self._workers)

    def __iter__(self):
        return iter(self._pf)
