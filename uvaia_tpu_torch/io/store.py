"""Reading persistent database stores: the port's copy of the reading
half of ``uvaia_tpu/io/store.py`` (``is_store``, ``peek_store_base``,
``Store``, ``StoreBatch``, ``StoreStreamer``), so the port scans stores
written by ``uvaia_tpu ingest`` decode-free, exactly as the JAX package
does.  ``ingest``, ``info`` and ``verify`` are not ported yet.

Store layout (a directory, so every section is written streamingly and
mmap-ed independently):

  meta.json          format marker + dimensions; written LAST (commit
                     marker: a crashed ingest leaves no meta -> not a
                     store)
  packed.bin         (n_rows, ceil(L/2)) uint8 — 4-bit IUPAC codes, two
                     per byte (ops/host.pack_codes layout), always
                     present: any engine can read exact codes for any
                     row without touching the delta sections
  valid.npy          (n_rows,) int32 valid-site counts (the QC number,
                     fastaseq.c:642-648) so ref_ambiguity filtering at
                     scan time is a vectorised compare, not a decode
  names.bin          concatenated utf-8 names
  name_offsets.npy   (n_rows+1,) int64 ends into names.bin
  base.bin           (L,) uint8 delta base: per-site majority code of
                     the first block (present iff any delta block)
  delta_pos.bin      per-block (n, E) uint16 diff positions, contiguous
  delta_val.bin      per-block (n, E) uint8 diff values (incl. the
                     zero-run markers of host.delta_encode)
  blocks.npy         (n_blocks, 5) int64: row0, n, E, pos_byte_off,
                     val_byte_off.  E == 0 marks a block whose rows
                     overflowed every delta bucket (scan falls back to
                     its packed.bin rows)
  block_crc.npy      (n_blocks,) int64 CRC32 over each block's bytes in
                     EVERY section (packed rows, names, valid counts,
                     gap runs, exceptions, dump frames, delta pos/val —
                     composition id: meta "crc" == CRC_SCHEME), computed
                     at ingest; verify() recomputes them (-1 = block
                     predates checksums).  Scans never read it:
                     integrity checking is an explicit `info --verify`
  gapruns.bin        (total_runs, 2) uint32 (start, len) runs of '-' —
                     codes are lossy ('-' and 'N' both encode to 0,
                     core/encoding.py); runs restore the distinction so
                     the neighbour dump (.aln.xz) stays byte-identical
  gaprun_offsets.npy (n_rows+1,) int64 run-count ends per row
  exc_pos.bin        uint32 / exc_chr.bin uint8 / exc_offsets.npy —
                     rare positions where the canonical decode still
                     differs from the original byte (e.g. '?', 'U'):
                     applied last, making decode_row exact for ANY
                     input
  rowxz.bin          OPTIONAL (ingest --frames) per-row PRE-COMPRESSED
                     dump frames: each row's ">name\nseq\n" as one
                     complete xz stream (the multi-stream format every
                     engine output already uses,
                     io/fasta.ParallelXzFastaWriter).  The neighbour
                     dump of a store scan is then pure file
                     concatenation — measured 3.2s of a 6.2s real-DB
                     indexed run was re-compressing survivor genomes.
                     Off by default: see ingest() for the economics
  rowxz_offsets.npy  (n_rows+1,) int64 ends into rowxz.bin

The delta sections are the fast path: a scan uploads the (pos, val)
lists (~3 bytes/diff vs ~15KB/row packed) and the device rebuilds exact
codes against ``base.bin`` (ops/recon.delta_rebuild) — the engines
simply override the query-majority delta base with the store base.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..core.encoding import DECODE_LUT
from ..utils.prefetch import Prefetcher

FORMAT = "uvaia-tpu-store"


def _unpack_nibbles(pk: np.ndarray, n_sites: int) -> np.ndarray:
    """(n, w2) packed uint8 -> (n, n_sites) 4-bit codes — THE host-side
    inverse of ops/host.pack_codes (device-side: score_kernels.unpack_codes).
    Single definition so Store.codes_rows cannot drift from the packing
    layout."""
    codes = np.empty((pk.shape[0], pk.shape[1] * 2), dtype=np.uint8)
    codes[:, 0::2] = pk >> 4
    codes[:, 1::2] = pk & 0xF
    return codes[:, :n_sites]


def is_store(path) -> bool:
    """True when `path` is a store directory with a committed meta."""
    meta = Path(path) / "meta.json"
    if not meta.is_file():
        return False
    try:
        with open(meta) as fh:
            return json.load(fh).get("format") == FORMAT
    except (OSError, json.JSONDecodeError):
        return False


def peek_store_base(path) -> np.ndarray | None:
    """The store's delta base without opening the full store (engines
    need it before building device data), or None if the store carries
    no delta sections."""
    base = Path(path) / "base.bin"
    if not base.is_file():
        return None
    return np.fromfile(base, dtype=np.uint8)


# ----------------------------------------------------------------------
# reading


class Store:
    """mmap view over an ingested store directory."""

    def __init__(self, path):
        self.path = Path(path)
        with open(self.path / "meta.json") as fh:
            self.meta = json.load(fh)
        if self.meta.get("format") != FORMAT:
            raise SystemExit(f"{path} is not a uvaia-tpu store")
        self.n_rows = int(self.meta["n_rows"])
        self.n_sites = int(self.meta["n_sites"])
        self.w2 = int(self.meta["w2"])
        self.packed = np.memmap(self.path / "packed.bin", dtype=np.uint8,
                                mode="r", shape=(self.n_rows, self.w2))
        self.valid = np.load(self.path / "valid.npy")
        self.name_offsets = np.load(self.path / "name_offsets.npy")
        with open(self.path / "names.bin", "rb") as fh:
            self._names_blob = fh.read()
        self.blocks = np.load(self.path / "blocks.npy")
        self.has_delta = bool(self.meta.get("has_delta"))
        if self.has_delta:
            self.base = np.fromfile(self.path / "base.bin", dtype=np.uint8)
            self.delta_pos = np.memmap(self.path / "delta_pos.bin",
                                       dtype=np.uint8, mode="r")
            self.delta_val = np.memmap(self.path / "delta_val.bin",
                                       dtype=np.uint8, mode="r")
        else:
            self.base = None
        self._runs = None
        if self.meta.get("has_rowxz"):
            self._rowxz = np.memmap(self.path / "rowxz.bin",
                                    dtype=np.uint8, mode="r")
            self._rowxz_off = np.load(self.path / "rowxz_offsets.npy")
        else:
            self._rowxz = None

    # -- names ----------------------------------------------------------

    def name(self, r: int) -> str:
        o = self.name_offsets
        return self._names_blob[o[r]:o[r + 1]].decode("utf-8",
                                                      errors="replace")

    def names_range(self, r0: int, n: int) -> list[str]:
        o = self.name_offsets
        blob = self._names_blob
        return [blob[o[r]:o[r + 1]].decode("utf-8", errors="replace")
                for r in range(r0, r0 + n)]

    # -- per-block payloads ----------------------------------------------

    def block_delta(self, bi: int):
        """(pos (n, E) uint16 view, val (n, E) uint8 view) of block bi,
        or None when the block has no delta (E == 0)."""
        row0, n, E, poff, voff = (int(x) for x in self.blocks[bi])
        if E == 0:
            return None
        pos = self.delta_pos[poff:poff + n * E * 2].view(
            np.uint16).reshape(n, E)
        val = self.delta_val[voff:voff + n * E].reshape(n, E)
        return pos, val

    # -- exact row decode -------------------------------------------------

    def _lazy_decode_meta(self):
        if self._runs is None:
            self._runs = np.fromfile(
                self.path / "gapruns.bin", dtype=np.uint32).reshape(-1, 2)
            self._run_off = np.load(self.path / "gaprun_offsets.npy")
            self._exc_pos = np.fromfile(
                self.path / "exc_pos.bin", dtype=np.uint32)
            self._exc_chr = np.fromfile(
                self.path / "exc_chr.bin", dtype=np.uint8)
            self._exc_off = np.load(self.path / "exc_offsets.npy")

    def codes_row(self, r: int) -> np.ndarray:
        """(L,) uint8 codes of row r, unpacked from packed.bin."""
        return self.codes_rows(np.asarray([r]))[0]

    def codes_rows(self, rows) -> np.ndarray:
        """(len(rows), L) uint8 codes for arbitrary row indices —
        decode-free bulk access for host-side consumers (the legacy
        tool's in-memory scoring store, engine/legacy.py)."""
        pk = np.asarray(self.packed[np.asarray(rows, dtype=np.int64)])
        return _unpack_nibbles(pk, self.n_sites)

    def seq_row(self, r: int) -> bytes:
        """Original (uppercased) sequence bytes of row r — exact: codes
        -> canonical chars, '-' runs restored, residual exceptions
        applied."""
        self._lazy_decode_meta()
        chars = DECODE_LUT[self.codes_row(r)]
        for s, ln in self._runs[self._run_off[r]:self._run_off[r + 1]]:
            chars[s:s + ln] = ord("-")
        e0, e1 = self._exc_off[r], self._exc_off[r + 1]
        if e1 > e0:
            chars[self._exc_pos[e0:e1]] = self._exc_chr[e0:e1]
        return chars.tobytes()

    def frame_row(self, r: int) -> bytes | None:
        """Pre-compressed xz dump frame of row r (">name\\nseq\\n" as a
        complete xz stream), or None for a store without frames."""
        if self._rowxz is None:
            return None
        o0, o1 = self._rowxz_off[r], self._rowxz_off[r + 1]
        return self._rowxz[o0:o1].tobytes()


# ----------------------------------------------------------------------
# streaming scans from stores


@dataclass
class StoreBatch:
    """RefBatch-compatible batch whose payload came from store mmaps.

    ``pieces`` — ordered (store, row_indices) spans covering rows
    [0, n); ``seq(i)`` decodes on demand (only dump survivors ever ask).
    """
    ok: np.ndarray
    names: list[str]
    base_idx: int
    n: int
    records_read: int = 0
    n_invalid: int = 0
    same_name: int = 0
    pieces: list = field(default_factory=list)

    def seq(self, i: int) -> bytes:
        for store, rows in self.pieces:
            if i < len(rows):
                return store.seq_row(int(rows[i]))
            i -= len(rows)
        raise IndexError(i)

    def frame(self, i: int) -> bytes | None:
        """Pre-compressed dump frame for row i (engines write it via
        ParallelXzFastaWriter.write_compressed — no re-compression)."""
        for store, rows in self.pieces:
            if i < len(rows):
                return store.frame_row(int(rows[i]))
            i -= len(rows)
        raise IndexError(i)

class StoreStreamer:
    """Streams (StoreBatch, payload) pairs from one or more stores —
    the drop-in replacement for RefStreamer + EncodedStream when every
    reference path is a store.

    Payloads: ("delta", pos (B, E) uint16, val (B, E) uint8) against
    ``self.base`` (the FIRST store's base — engines must override the
    device delta base with it), or ("packed", (B, w2) uint8).  A store
    whose base differs byte-wise from the first store's, or which has
    no delta, serves packed payloads (always exact, never re-encoded).

    QC mirrors RefStreamer: same-name exclusion precedes the valid-site
    threshold (nearest.c:255-270); kept rows are compacted; batches are
    fixed-shape with ``ok`` masking the padded tail.  Rows stream in
    store order, preserving the ascending-global-index invariant
    merge_topk relies on.
    """

    def __init__(self, paths: list[str], n_sites: int, batch: int,
                 ref_ambiguity: float = 0.5,
                 exclude_names: set[str] | None = None,
                 prefetch: int = 4,
                 skip_records: int = 0, initial_base: int = 0,
                 limit_records: int = 0):
        from ..engine.stream import StreamStats
        self.stores = [Store(p) for p in paths]
        for st in self.stores:
            if st.n_sites != n_sites:
                raise SystemExit(
                    f"Store {st.path} holds {st.n_sites}-site sequences "
                    f"but query sequences have {n_sites} sites: all "
                    "sequences must be aligned")
        self.n_sites = n_sites
        self.batch = batch
        self.min_valid = int(n_sites * (1.0 - ref_ambiguity))
        self.exclude_names = exclude_names or set()
        self.skip_records = skip_records
        self.initial_base = initial_base
        # raw-record window END (exclusive, global across the path
        # list; 0 = unbounded): together with skip_records this scans
        # rows [skip, limit) — the multihost row splitter's contract
        self.limit_records = limit_records
        self.stats = StreamStats()
        import os as _os
        import sys as _sys
        if _os.environ.get("UVAIA_TPU_STRICT_CHARS"):
            # store rows were canonicalised to 4-bit codes at ingest —
            # the original bytes are gone, so the dirty-character guard
            # cannot re-check them here.  Say so ONCE instead of
            # silently skipping the knob the user set (the guard DID
            # run at ingest time if the env was set then, via
            # RefStreamer).
            print("UVAIA_TPU_STRICT_CHARS: ingested stores hold "
                  "canonicalised codes; unrecognised characters can "
                  "only be detected at ingest time, not when scanning "
                  f"{paths[0]}", file=_sys.stderr, flush=True)
        self.base = next(
            (st.base for st in self.stores if st.base is not None), None)
        self._pf = Prefetcher(self._batches, maxsize=prefetch)

    def __iter__(self):
        return iter(self._pf)

    # ------------------------------------------------------------------

    def _pieces(self):
        """Per store block, after skip + QC compaction:
        (store, rows (local indices), names, last_raw (global raw index
        of the block's last row), payload piece or None-for-packed).
        Also appends reject events for exact checkpoint bookkeeping."""
        skip = self.skip_records
        lim = self.limit_records
        raw_off = 0
        base = self.base
        for st in self.stores:
            if lim and raw_off >= lim:
                break
            self.stats.files.append(str(st.path))
            use_delta = (st.has_delta and base is not None
                         and st.base is not None
                         and st.base.shape == base.shape
                         and bool((st.base == base).all()))
            for bi in range(st.blocks.shape[0]):
                row0, nb, E = (int(x) for x in st.blocks[bi, :3])
                if lim:
                    # blocks ascend in row0: past the window end, done
                    if raw_off + row0 >= lim:
                        break
                    nb = min(nb, lim - raw_off - row0)
                if skip >= nb:
                    skip -= nb
                    continue
                lo = skip
                skip = 0
                rows = np.arange(row0 + lo, row0 + nb)
                names = st.names_range(row0 + lo, nb - lo)
                keep = np.asarray(st.valid[rows] >= self.min_valid)
                if self.exclude_names:
                    excl = np.array([nm in self.exclude_names
                                     for nm in names])
                    keep &= ~excl
                    inval = ~keep & ~excl
                else:
                    excl = None
                    inval = ~keep
                # rejects sorted by raw index (the emit watermark walk
                # assumes monotone order)
                rej = [(raw_off + int(r), "invalid") for r in rows[inval]]
                if excl is not None:
                    rej += [(raw_off + int(r), "same") for r in rows[excl]]
                self._rejects.extend(sorted(rej))
                self.stats.count += nb - lo
                kept_rows = rows[keep]
                kept_names = [nm for nm, k in zip(names, keep) if k]
                payload = None
                if use_delta and E > 0 and len(kept_rows):
                    pos, val = st.block_delta(bi)
                    sel = kept_rows - row0
                    if len(sel) == pos.shape[0]:
                        payload = (pos, val)       # zero-copy mmap view
                    else:
                        payload = (pos[sel], val[sel])
                if len(kept_rows):
                    yield (st, kept_rows, kept_names,
                           raw_off + int(kept_rows[-1]), payload)
            raw_off += st.n_rows

    def _assemble(self, pieces, n):
        """Combine compacted pieces into one fixed-shape payload."""
        B = self.batch
        L = self.n_sites
        if all(p[4] is not None for p in pieces):
            E = max(p[4][0].shape[1] for p in pieces)
            pos = np.broadcast_to(
                np.arange(L, L + E, dtype=np.uint16)[None, :],
                (B, E)).copy()
            val = np.zeros((B, E), dtype=np.uint8)
            at = 0
            for _, rows, _, _, (ppos, pval) in pieces:
                k, e = ppos.shape
                pos[at:at + k, :e] = ppos
                val[at:at + k, :e] = pval
                at += k
            return "delta", pos, val
        packed = np.zeros((B, self.stores[0].w2), dtype=np.uint8)
        at = 0
        for st, rows, _, _, _ in pieces:
            if len(rows) and rows[-1] - rows[0] + 1 == len(rows):
                packed[at:at + len(rows)] = st.packed[rows[0]:rows[-1] + 1]
            else:
                packed[at:at + len(rows)] = st.packed[rows]
            at += len(rows)
        return "packed", packed

    def _batches(self):
        """Generator run on the Prefetcher's thread."""
        self._rejects = []
        rej_ptr = 0
        n_inval = n_same = 0
        base_idx = self.initial_base
        buf: list = []
        buf_n = 0

        def emit(pieces, n, last_raw):
            nonlocal base_idx, rej_ptr, n_inval, n_same
            while (rej_ptr < len(self._rejects)
                   and self._rejects[rej_ptr][0] <= last_raw):
                if self._rejects[rej_ptr][1] == "same":
                    n_same += 1
                else:
                    n_inval += 1
                rej_ptr += 1
            self.stats.n_invalid = n_inval
            self.stats.same_name = n_same
            kind, *arrs = self._assemble(pieces, n)
            names = [nm for p in pieces for nm in p[2]]
            ok = np.zeros(self.batch, dtype=bool)
            ok[:n] = True
            b = StoreBatch(ok=ok, names=names, base_idx=base_idx, n=n,
                           records_read=last_raw + 1,
                           n_invalid=n_inval, same_name=n_same,
                           pieces=[(p[0], p[1]) for p in pieces])
            base_idx += n
            return b, (kind, *arrs)

        for st, rows, names, last_raw, payload in self._pieces():
            raw_of_last = last_raw - int(rows[-1])   # raw_off of this store
            while buf_n + len(rows) >= self.batch:
                take = self.batch - buf_n            # > 0: buf_n < batch
                head_raw = raw_of_last + int(rows[take - 1])
                piece = (st, rows[:take], names[:take], head_raw,
                         None if payload is None
                         else (payload[0][:take], payload[1][:take]))
                yield emit(buf + [piece], self.batch, head_raw)
                rows, names = rows[take:], names[take:]
                payload = (None if payload is None
                           else (payload[0][take:], payload[1][take:]))
                buf, buf_n = [], 0
            if len(rows):
                buf.append((st, rows, names, last_raw, payload))
                buf_n += len(rows)
                buf_last = last_raw
        if buf_n:
            yield emit(buf, buf_n, buf_last)
        # trailing rejects (after the last accepted row) still count
        self.stats.n_invalid = n_inval + sum(
            1 for e in self._rejects[rej_ptr:] if e[1] == "invalid")
        self.stats.same_name = n_same + sum(
            1 for e in self._rejects[rej_ptr:] if e[1] == "same")
