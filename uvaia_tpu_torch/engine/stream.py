"""Host-side streaming for the port's scans.

``RefBatch``, ``dump_entry``, ``write_dump``, ``StreamStats`` and
``RefStreamer`` are the port's copies of ``uvaia_tpu/engine/stream.py``'s
(a background reader thread feeding fixed-shape encoded batches through
a bounded queue, the native reader's batched API on the fast path);
:class:`EncodedStream` is the counterpart of its encode stage, encoding
with the port's jax-free host module (ops/host.py);
:func:`open_reference_stream` opens ``nearest``'s and ``ball``'s input.
The native reader takes every file whose codec the port's library was
built with; the others (bz2 always, xz where the machine has no
liblzma) go through the Python reader.  An uncompressed file is mapped
and its records parsed straight into each batch's rows, to the same
chunks: in ranges of RANGE_ROWS records on a pool of
:func:`read_workers` threads when it holds two ranges, else at once on
the reader thread.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import weakref
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field

import numpy as np

from ..core.encoding import ENCODE_LUT, RECOGNISED, strict_chars_check
from ..io import native
from ..io import store as store_mod
from ..io.compress import sniff_codec
from ..io.fasta import read_fasta
from ..ops import host
from ..utils import observe
from ..utils.prefetch import Prefetcher, ordered_pool_map

__all__ = ["EncodedStream", "RefBatch", "RefStreamer", "StreamStats",
           "dump_entries", "dump_entry", "open_reference_stream",
           "write_dump"]


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

    def seq_many(self, idx) -> list[bytes]:
        return [self.seq(int(i)) for i in idx]

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


def dump_entries(batch, idx) -> list[tuple]:
    """``[dump_entry(batch, i) for i in idx]``, with the rows that carry
    no dump frame decoded in one ``batch.seq_many`` call (a store batch
    decodes them natively in bulk, a FASTA batch slices its rows)."""
    idx = [int(i) for i in idx]
    frames = [batch.frame(i) for i in idx]
    seqs = iter(batch.seq_many([i for i, f in zip(idx, frames)
                                if f is None]))
    return [(batch.names[i], None, f) if f is not None
            else (batch.names[i], next(seqs), None)
            for i, f in zip(idx, frames)]


def write_dump(writer, entry) -> None:
    """Write a dump_entry through a FASTA dump writer (both writer
    classes implement write_compressed: the xz writer splices the
    pre-compressed frame verbatim, a --codec writer re-encodes it)."""
    name, seq, frame = entry
    if frame is not None:
        writer.write_compressed(frame)
    else:
        writer.write(name, seq)


#: Records a range: what one worker of RefStreamer's pool parses at a
#: time.  A raw file takes the pool when it may hold two ranges.
RANGE_ROWS = 256
#: The pool's most workers.
MAX_READ_WORKERS = 4


def read_workers() -> int:
    """The pool's size: the cores this process may use less the main
    thread, the reader thread and the encode pool's min(2, cores - 1),
    at most MAX_READ_WORKERS, and at least 1 (the reader thread waits
    while the pool parses, so one worker uses no more cores than the
    serial reader)."""
    cores = len(os.sched_getaffinity(0)) \
        if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1
    encode = max(1, min(2, cores - 1))
    return max(1, min(MAX_READ_WORKERS, cores - 2 - encode))


class _Lease:
    """Lends a row buffer to the arrays of one batch: every view of the
    batch's rows hangs from the lease, which goes when the last does."""

    def __init__(self, mem: np.ndarray):
        self.mem = mem
        self.__array_interface__ = mem.__array_interface__


class _RowBuffers:
    """The (raw, codes) rows of one stream's mapped batches, views of
    (2, batch, n_sites) buffers.  A buffer comes back to the stream when
    the last array that views its batch is gone, and the next batch takes
    it before a new one is mapped; so the stream holds no more buffers
    than it ever had batches alive, and lets them go with itself.  For
    the pool a new buffer is mapped with its pages populated at once
    (MAP_POPULATE): first writes into fresh memory otherwise fault a
    page at a time, and on several threads those faults cost the parse
    as much as it costs itself.  The job counts the buffers it maps as
    ``row_buffers``."""

    def __init__(self, batch: int, n_sites: int):
        self.shape = (2, batch, n_sites)
        self.free: list[np.ndarray] = []

    def take(self, populate: bool) -> tuple[np.ndarray, np.ndarray]:
        try:
            mem = self.free.pop()
        except IndexError:
            flags = mmap.MAP_PRIVATE
            if populate:
                flags |= getattr(mmap, "MAP_POPULATE", 0)
            mm = mmap.mmap(-1, int(np.prod(self.shape)), flags=flags)
            mem = np.frombuffer(mm, dtype=np.uint8).reshape(self.shape)
            observe.count("row_buffers", 1)
        lease = _Lease(mem)
        weakref.finalize(lease, self.free.append, mem).atexit = False
        rows = np.asarray(lease)
        return rows[0], rows[1]


def _ranged(path, n_sites: int) -> bool:
    """Whether a raw file is large enough for two ranges of aligned
    records (each at least '>', '\\n' and n_sites bytes)."""
    return os.path.getsize(path) >= 2 * RANGE_ROWS * (n_sites + 2)


def _aligned_names(namebuf, ends, lens, k: int, L: int) -> list[str]:
    """The k names the native readers wrote into ``namebuf`` (name i
    ends at ``ends[i]``); SystemExit at the first record whose length
    ``lens[i]`` is not L."""
    blob = ctypes.string_at(namebuf, int(ends[k - 1]))
    names, start = [], 0
    for i in range(k):
        names.append(blob[start:ends[i]].decode("utf-8", errors="replace"))
        start = ends[i]
    for i in range(k):
        if lens[i] != L:
            raise SystemExit(
                f"Reference sequence '{names[i]}' has {lens[i]} sites "
                f"but query sequences have {L} sites: all sequences must "
                "be aligned")
    return names


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
    length mismatch.  Each batch is a ``stream_read`` span on the
    reader thread and adds the raw bytes of the rows it hands on
    (n x L) to the job's ``stream_bytes``.  Where the pool reads a raw
    file, each of its ranges is a ``read_range`` span on a worker; the
    job counts the pool's size as ``read_workers`` (0 when no file took
    it), the records it parsed as ``range_rows``, and the row buffers
    mapped for raw files' batches as ``row_buffers``.
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
        self._pf = Prefetcher(
            lambda: observe.iter_spans("stream_read", self._batches()),
            maxsize=prefetch)

    def __iter__(self):
        return iter(self._pf)

    # ------------------------------------------------------------------

    def _records(self):
        """Yield (names, raw_chars (k, L), codes-or-None,
        valid-counts-or-None) chunks: a raw file mapped and parsed in
        ranges (on the pool when it holds two ranges, else on this
        thread), every other file the library reads from its serial
        reader, the rest in Python."""
        lib = native.get_lib()
        natively = {"raw", *native.codecs(lib)} if lib is not None else ()
        observe.count("read_workers", 0)
        observe.count("range_rows", 0)
        rows = _RowBuffers(self.batch, self.n_sites)
        pool = None
        try:
            for path in self.paths:
                self.stats.files.append(path)
                codec = sniff_codec(path)
                if codec == "raw" and lib is not None and \
                        os.path.isfile(path):
                    pooled = _ranged(path, self.n_sites)
                    if pooled and pool is None:
                        workers = read_workers()
                        pool = ThreadPoolExecutor(workers)
                        observe.count("read_workers", workers)
                    yield from self._range_chunks(
                        lib, path, rows, pool if pooled else None)
                elif codec in natively:
                    yield from self._native_chunks(lib, path)
                else:
                    yield from self._python_chunks(path)
        finally:
            if pool is not None:
                pool.shutdown()

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
                yield (_aligned_names(namebuf, ends, lens, k, L), raw[:k],
                       codes[:k], np.asarray(valid[:k], dtype=np.int64))
        finally:
            lib.ufa_close(handle)

    def _range_chunks(self, lib, path, rows, pool):
        """The serial reader's chunks of a raw file: each batch's records
        found by one native call, then parsed straight into the batch's
        rows, in ranges of RANGE_ROWS records on ``pool``, or at once
        here when there is none."""
        L, chunk = self.n_sites, self.batch
        handle = lib.ufa_map_open(os.fsencode(path))
        if not handle:
            raise SystemExit(f"cannot open reference file {path}")
        namecap = 1024 * chunk
        namebuf = ctypes.create_string_buffer(namecap)
        ends, lens, valid, seq_off, seq_end = (
            np.empty(chunk, dtype=np.int64) for _ in range(5))
        lut = ENCODE_LUT.tobytes()
        pos = ctypes.c_long(0)

        def ptr(a, i=0):
            return a.ctypes.data + i * a.strides[0]

        def parse(raw, codes, i, j):
            return lib.ufa_map_parse(
                handle, ptr(seq_off, i), ptr(seq_end, i), j - i, lut, L,
                ptr(raw, i), ptr(codes, i), ptr(lens, i), ptr(valid, i))

        parse_range = observe.span("read_range")(parse)

        try:
            while True:
                k = lib.ufa_map_find(
                    handle, ctypes.byref(pos), chunk, namebuf, namecap,
                    ptr(ends), ptr(seq_off), ptr(seq_end))
                if k < 0:
                    raise SystemExit(f"error reading {path}")
                if k == 0:
                    return
                raw, codes = rows.take(pool is not None)
                if pool is None:
                    parse(raw, codes, 0, k)
                else:
                    parts = [pool.submit(parse_range, raw, codes, i,
                                         min(i + RANGE_ROWS, k))
                             for i in range(0, k, RANGE_ROWS)]
                    wait(parts)
                    for f in parts:
                        f.result()
                    observe.count("range_rows", k)
                yield (_aligned_names(namebuf, ends, lens, k, L), raw[:k],
                       codes[:k], valid[:k].copy())
        finally:
            lib.ufa_map_close(handle)

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
            observe.count("stream_bytes", count * self.n_sites)
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
    floor 1, as in the JAX package; the job counts it as
    ``encode_workers``, and each batch's encode is a ``delta_encode``
    span on the worker that ran it."""

    def __init__(self, streamer: RefStreamer, delta_base: np.ndarray,
                 prefetch: int = 2, workers: int | None = None):
        self.streamer = streamer
        self.delta_base = delta_base
        if workers is None:
            workers = int(os.environ.get(
                "UVAIA_TPU_ENCODE_THREADS",
                max(1, min(2, (os.cpu_count() or 1) - 1))))
        self._workers = max(1, workers)
        observe.count("encode_workers", self._workers)
        self._pf = Prefetcher(self._batches,
                              maxsize=max(prefetch, self._workers))

    @observe.span("delta_encode")
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


def open_reference_stream(paths: list[str], n_sites: int, batch: int,
                          query_base: np.ndarray, limit_records: int = 0,
                          **streamer_kw):
    """(streamer, (batch, payload) pairs, the payloads' delta base) of
    all-store or all-FASTA inputs: a store's own payloads, against its
    base if it has one, or FASTA encoded against ``query_base``."""
    n_store = sum(store_mod.is_store(p) for p in paths)
    if n_store and n_store != len(paths):
        raise SystemExit(
            "reference inputs mix ingested stores and FASTA files; "
            "scan them in separate runs (or ingest the FASTA too)")
    if not n_store:
        if limit_records:
            raise SystemExit(
                "record-window scanning (limit_records) requires "
                "ingested store inputs")
        streamer = RefStreamer(paths, n_sites, batch, **streamer_kw)
        return streamer, EncodedStream(streamer, query_base), query_base
    streamer = store_mod.StoreStreamer(paths, n_sites, batch,
                                       limit_records=limit_records,
                                       **streamer_kw)
    base = store_mod.peek_store_base(paths[0])
    return streamer, streamer, query_base if base is None else base
