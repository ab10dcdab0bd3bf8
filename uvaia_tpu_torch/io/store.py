"""Persistent database stores: the port's copy of
``uvaia_tpu/io/store.py``.  ``ingest`` writes a store once (byte for
byte the directory ``uvaia_tpu ingest`` writes from the same FASTA),
``info`` and ``verify`` inspect and check one, and ``Store``,
``StoreBatch`` and ``StoreStreamer`` feed the scans from it
decode-free.  Host code only: the rows are digested by the port's
native library (csrc/host/fasta_io.cpp ``ufa_store_block``) or, without
it, by numpy, and delta-encoded by ops/host.py.

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

import ctypes
import json
import os
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..core.encoding import DECODE_LUT
from ..utils import observe
from ..utils.prefetch import Prefetcher

FORMAT = "uvaia-tpu-store"
VERSION = 1
#: integrity-checksum composition id (meta "crc"): what byte sections
#: each block_crc.npy entry covers.  Bumped if the composition ever
#: changes; verify() treats any other scheme's entries as unknown.
CRC_SCHEME = 2
DEFAULT_BLOCK = 4096


#: the two characters of each packed byte (high nibble first), the
#: table of the native row decode (``Store.seq_rows``)
_DECODE_PAIRS = np.stack([DECODE_LUT[np.arange(256) >> 4],
                          DECODE_LUT[np.arange(256) & 15]], axis=1)


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


def peek_store_rows(path) -> int:
    """Row count from meta.json alone (no mmap, no names blob) — the
    multihost row splitter needs counts before any host opens stores."""
    with open(Path(path) / "meta.json") as fh:
        return int(json.load(fh)["n_rows"])


def info(path) -> dict:
    """Inspect a committed store without loading it: meta fields plus
    per-component on-disk bytes (committed extents only — a crashed
    append may leave orphan bytes past the meta, which `--append`
    truncates on its next run) and the valid-site distribution.

    The reference has no persistent index to inspect; this serves the
    store format's own operability (the analogue of its stderr QC
    summary, utils.c:11-48, for an already-ingested database).
    """
    p = Path(path)
    if not is_store(p):
        raise ValueError(f"{path} is not a committed {FORMAT} directory")
    with open(p / "meta.json") as fh:
        meta = json.load(fh)
    out = {k: meta[k] for k in ("format", "version", "n_rows", "n_sites",
                                "block", "sources")}
    # .get: stores written before a feature landed lack its meta key
    # (VERSION stays 1, additions are backwards-compatible)
    out["has_delta"] = bool(meta.get("has_delta"))
    out["has_rowxz"] = bool(meta.get("has_rowxz"))
    n_rows = int(meta["n_rows"])
    # committed entries only: a crashed append may have saved longer
    # arrays than its meta commit covers (same clip as ingest/verify)
    committed = [b for b in np.load(p / "blocks.npy")
                 if int(b[0]) < n_rows]
    blocks = np.asarray(committed, dtype=np.int64).reshape(-1, 5)
    # delta blocks record their bucket width E > 0; packed-only blocks
    # are written as (row0, n, 0, 0, 0) (see ingest above)
    n_delta = int((blocks[:, 2] > 0).sum()) if blocks.size else 0
    out["n_blocks"] = int(blocks.shape[0])
    out["n_delta_blocks"] = n_delta
    out["n_packed_only_blocks"] = int(blocks.shape[0]) - n_delta
    valid = np.load(p / "valid.npy", mmap_mode="r")[:n_rows]
    if valid.size:
        out["valid_sites"] = {"min": int(valid.min()),
                              "mean": round(float(valid.mean()), 1),
                              "max": int(valid.max())}
    crc_file = p / "block_crc.npy"
    out["crc_blocks"] = int(
        (np.load(crc_file)[: blocks.shape[0]] >= 0).sum()) \
        if crc_file.is_file() and meta.get("crc") == CRC_SCHEME else 0
    sizes = {f.name: f.stat().st_size for f in sorted(p.iterdir())
             if f.is_file()}
    out["component_bytes"] = sizes
    out["total_bytes"] = sum(sizes.values())
    return out


def verify(path, progress=None) -> dict:
    """Recompute every committed block's CRC32 against block_crc.npy
    — covering the block's packed rows, names, valid counts, gap runs,
    decode exceptions, dump frames and delta sections (everything the
    ingest hashed, see the CRC composition in ingest()) — plus
    structural checks (offsets present, sized and monotonic; committed
    extents fit their files).  Returns
    ``{"ok", "checked", "unknown", "bad_blocks", "errors"}`` —
    bit-rot in a persistent index silently corrupts downstream science,
    so this is the explicit operability pass (the reference has no
    persistent index; its xz inputs carry their own stream checksums).
    Blocks of a store ingested before checksums landed count as
    ``unknown``, never as corrupt.

    ``progress(blocks_done, n_blocks)`` is called per block when given.
    """
    p = Path(path)
    if not is_store(p):
        raise ValueError(f"{path} is not a committed {FORMAT} directory")
    with open(p / "meta.json") as fh:
        meta = json.load(fh)
    n_rows, w2 = int(meta["n_rows"]), int(meta["w2"])
    blocks = np.load(p / "blocks.npy")
    errors: list[str] = []

    def _mm(name):
        """1-D uint8 view of a bin file, or None (recorded) if absent."""
        f = p / name
        if not f.is_file():
            errors.append(f"{name}: missing")
            return None
        sz = f.stat().st_size
        return np.memmap(f, dtype=np.uint8, mode="r") if sz else \
            np.empty(0, np.uint8)

    def _offsets(name):
        """Committed offsets array, validated; None (recorded) on any
        structural problem so the CRC loop can skip what it can't
        locate instead of crashing."""
        f = p / name
        if not f.is_file():
            errors.append(f"{name}: missing")
            return None
        off = np.load(f)
        if off.shape[0] < n_rows + 1:
            errors.append(f"{name}: {off.shape[0]} ends < {n_rows + 1}")
            return None
        off = off[: n_rows + 1]
        if off.shape[0] and (np.diff(off) < 0).any():
            errors.append(f"{name}: offsets not monotonic")
            return None
        return off

    packed = _mm("packed.bin")
    names = _mm("names.bin")
    runs = _mm("gapruns.bin")
    epos = _mm("exc_pos.bin")
    echr = _mm("exc_chr.bin")
    name_off = _offsets("name_offsets.npy")
    run_off = _offsets("gaprun_offsets.npy")
    exc_off = _offsets("exc_offsets.npy")
    valid = None
    if (p / "valid.npy").is_file():
        valid = np.load(p / "valid.npy", mmap_mode="r")
        if valid.shape[0] < n_rows:
            errors.append(f"valid.npy: {valid.shape[0]} rows < {n_rows}")
            valid = None
    else:
        errors.append("valid.npy: missing")
    rowxz = rowxz_off = None
    if meta.get("has_rowxz"):
        rowxz = _mm("rowxz.bin")
        rowxz_off = _offsets("rowxz_offsets.npy")
    dpos = _mm("delta_pos.bin") if meta.get("has_delta") else \
        np.empty(0, np.uint8)
    dval = _mm("delta_val.bin") if meta.get("has_delta") else \
        np.empty(0, np.uint8)

    def _extent(name, arr, need):
        if arr is not None and arr.shape[0] < need:
            errors.append(f"{name}: {arr.shape[0]} bytes "
                          f"< committed {need}")

    _extent("packed.bin", packed, n_rows * w2)
    if name_off is not None:
        _extent("names.bin", names, int(name_off[n_rows]))
    if rowxz_off is not None:
        _extent("rowxz.bin", rowxz, int(rowxz_off[n_rows]))

    crc_file = p / "block_crc.npy"
    scheme_ok = crc_file.is_file() and meta.get("crc") == CRC_SCHEME
    crcs = (np.load(crc_file) if scheme_ok
            else np.full(blocks.shape[0], -1, dtype=np.int64))

    def _slice(arr, lo, hi, what, bi):
        """Committed byte range, or None (recorded as an error) when
        the file can't supply it."""
        if arr is None or hi > arr.shape[0] or lo > hi:
            errors.append(f"block {bi}: {what} range [{lo}, {hi}) "
                          "unavailable")
            return None
        return np.ascontiguousarray(arr[lo:hi]).tobytes()

    bad, unknown, checked = [], 0, 0
    for bi in range(blocks.shape[0]):
        row0, n, E, poff, voff = (int(x) for x in blocks[bi])
        if row0 >= n_rows:
            continue            # orphan of a crashed append
        if row0 + n > n_rows:
            # committed blocks are written whole before the meta
            # commit; a block sticking past n_rows is structural
            errors.append(f"block {bi}: rows [{row0}, {row0 + n}) "
                          f"exceed committed n_rows {n_rows}")
            continue
        want = int(crcs[bi]) if bi < crcs.shape[0] else -1
        if want == -1:
            unknown += 1
            continue
        pieces = [_slice(packed, row0 * w2, (row0 + n) * w2,
                         "packed", bi)]
        if name_off is not None:
            pieces.append(_slice(names, int(name_off[row0]),
                                 int(name_off[row0 + n]), "names", bi))
        else:
            pieces.append(None)
        pieces.append(
            np.ascontiguousarray(valid[row0: row0 + n],
                                 dtype=np.int64).tobytes()
            if valid is not None else None)
        if run_off is not None:
            pieces.append(_slice(runs, int(run_off[row0]) * 8,
                                 int(run_off[row0 + n]) * 8,
                                 "gapruns", bi))
        else:
            pieces.append(None)
        if exc_off is not None:
            pieces.append(_slice(epos, int(exc_off[row0]) * 4,
                                 int(exc_off[row0 + n]) * 4,
                                 "exc_pos", bi))
            pieces.append(_slice(echr, int(exc_off[row0]),
                                 int(exc_off[row0 + n]), "exc_chr", bi))
        else:
            pieces += [None, None]
        if rowxz_off is not None:
            pieces.append(_slice(rowxz, int(rowxz_off[row0]),
                                 int(rowxz_off[row0 + n]), "rowxz", bi))
        if E > 0:
            pieces.append(_slice(dpos, poff, poff + n * E * 2,
                                 "delta_pos", bi))
            pieces.append(_slice(dval, voff, voff + n * E,
                                 "delta_val", bi))
        checked += 1
        if any(pc is None for pc in pieces):
            bad.append(bi)      # a range we can't even read is corrupt
        else:
            crc = 0
            for pc in pieces:
                crc = zlib.crc32(pc, crc)
            if crc != want:
                bad.append(bi)
        if progress is not None:
            progress(bi + 1, blocks.shape[0])
    return {"ok": not bad and not errors, "checked": checked,
            "unknown": unknown, "bad_blocks": bad, "errors": errors}


def peek_store_base(path) -> np.ndarray | None:
    """The store's delta base without opening the full store (engines
    need it before building device data), or None if the store carries
    no delta sections."""
    base = Path(path) / "base.bin"
    if not base.is_file():
        return None
    return np.fromfile(base, dtype=np.uint8)


# ----------------------------------------------------------------------
# ingest


@dataclass
class IngestStats:
    n_rows: int = 0
    n_sites: int = 0
    n_delta_blocks: int = 0
    n_packed_blocks: int = 0
    seconds: float = 0.0
    bytes: int = 0


def _digest_block_native(lib, raw, codes):
    """(packed, valid, runs, run_counts, exc_pos, exc_chr, exc_counts)
    in ONE native pass (the numpy pipeline in ingest makes ~8 passes
    over the block)."""
    n, L = codes.shape
    w2 = (L + 1) // 2
    raw = np.ascontiguousarray(raw)
    codes = np.ascontiguousarray(codes)
    packed = np.empty((n, w2), dtype=np.uint8)
    valid = np.empty(n, dtype=np.int64)
    run_counts = np.empty(n, dtype=np.int64)
    exc_counts = np.empty(n, dtype=np.int64)
    runs_cap, exc_cap = 8 * n + 64, 8 * n + 64
    while True:
        runs = np.empty((runs_cap, 2), dtype=np.uint32)
        exc_pos = np.empty(exc_cap, dtype=np.uint32)
        exc_chr = np.empty(exc_cap, dtype=np.uint8)
        rc = lib.ufa_store_block(
            raw.ctypes.data_as(ctypes.c_void_p),
            codes.ctypes.data_as(ctypes.c_void_p), n, L,
            DECODE_LUT.ctypes.data_as(ctypes.c_void_p),
            packed.ctypes.data_as(ctypes.c_void_p),
            valid.ctypes.data_as(ctypes.c_void_p),
            runs.ctypes.data_as(ctypes.c_void_p), runs_cap,
            run_counts.ctypes.data_as(ctypes.c_void_p),
            exc_pos.ctypes.data_as(ctypes.c_void_p),
            exc_chr.ctypes.data_as(ctypes.c_void_p), exc_cap,
            exc_counts.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            break
        runs_cap *= 8                   # gap-heavy block: grow and retry
        exc_cap *= 8
    nr, ne = int(run_counts.sum()), int(exc_counts.sum())
    return (packed, valid.astype(np.int32), runs[:nr], run_counts,
            exc_pos[:ne], exc_chr[:ne], exc_counts)


def _gap_runs(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(runs (R, 2) uint32 [start, len] in row-major order,
    counts (n,) int64 runs per row) for '-' characters in (n, L) raw."""
    gaps = raw == ord("-")
    if not gaps.any():
        return (np.empty((0, 2), dtype=np.uint32),
                np.zeros(raw.shape[0], dtype=np.int64))
    g = gaps.astype(np.int8)
    d_start = np.diff(g, axis=1, prepend=0)
    d_end = np.diff(g, axis=1, append=0)
    sr, sc = np.nonzero(d_start == 1)
    er, ec = np.nonzero(d_end == -1)
    # starts and ends pair up in row-major order by construction
    runs = np.stack([sc, ec - sc + 1], axis=1).astype(np.uint32)
    counts = np.bincount(sr, minlength=raw.shape[0]).astype(np.int64)
    return runs, counts


def _truncate_to_meta(outp: Path, prev: dict, frames: bool) -> None:
    """Drop orphan TRAILING bytes a crashed earlier append may have
    left past the committed meta's row count — without this, re-running
    the append would interleave the orphans into the row space (the
    binary sections are parsed purely by offset)."""
    n = int(prev["n_rows"])
    w2 = int(prev["w2"])
    ends = {}
    for name in ("name_offsets", "gaprun_offsets", "exc_offsets",
                 "rowxz_offsets"):
        p = outp / f"{name}.npy"
        ends[name] = int(np.load(p)[n]) if p.is_file() else 0
    blocks = np.load(outp / "blocks.npy")
    pos_end = val_end = 0
    for row0, nb, E, poff, voff in blocks:
        if row0 >= n:
            continue          # orphan block from a crashed append
        if E > 0:
            pos_end = max(pos_end, int(poff) + int(nb) * int(E) * 2)
            val_end = max(val_end, int(voff) + int(nb) * int(E))
    sizes = {"packed.bin": n * w2,
             "names.bin": ends["name_offsets"],
             "gapruns.bin": ends["gaprun_offsets"] * 8,
             "exc_pos.bin": ends["exc_offsets"] * 4,
             "exc_chr.bin": ends["exc_offsets"],
             "delta_pos.bin": pos_end,
             "delta_val.bin": val_end}
    if frames:
        sizes["rowxz.bin"] = ends["rowxz_offsets"]
    for fname, size in sizes.items():
        p = outp / fname
        if p.is_file() and p.stat().st_size > size:
            os.truncate(p, size)


def ingest(paths: list[str], out: str, block: int = DEFAULT_BLOCK,
           progress=None, frames: bool = False,
           append: bool = False) -> IngestStats:
    """One streaming pass: FASTA/xz database(s) -> store directory.

    Rows are stored verbatim in input order (no QC — quality and name
    filters stay scan-time decisions driven by valid.npy and names, so
    one store serves every flag combination).  Unaligned input errors
    exactly like the scan would (RefStreamer length check).

    ``frames=True`` additionally pre-compresses every row as its own
    xz dump frame (Python's lzma module, so it works where the native
    library has no xz).  Off by default because the economics rarely
    pay: frames are compressed for ALL n_rows at ingest, one xz stream
    a row, while a scan's dump only needs its SURVIVORS, which the
    batched writer compresses on demand (io/fasta._GENOME_FILTERS).
    Opt in when the same store will be dump-scanned many times with
    large survivor sets.

    ``append=True`` extends an EXISTING store in place (the weekly
    surveillance-drop workflow: no full re-ingest).  New rows delta
    against the store's original base; the frames setting is inherited.
    meta.json is rewritten LAST (atomically), and every section is
    append-only or whole-array-rewritten-larger, so a crashed append
    leaves the previous meta pointing at a fully valid prefix — the
    store stays readable and the append can simply be re-run.
    """
    from ..engine.stream import RefStreamer
    from ..io.fasta import read_fasta
    from ..ops import host
    from . import native

    t0 = time.time()
    outp = Path(out)
    prev = None
    if append:
        if not is_store(out):
            raise SystemExit(f"{out} is not an existing store "
                             "(--append extends one)")
        with open(outp / "meta.json") as fh:
            prev = json.load(fh)
    elif outp.exists():
        raise SystemExit(f"{out} already exists; refusing to overwrite "
                         "an existing store or directory")
    else:
        outp.mkdir(parents=True)

    first = next(iter(read_fasta(paths[0])), None)
    if first is None:
        raise SystemExit(f"no sequences in {paths[0]}")
    L = len(first.seq)
    if prev is not None and L != int(prev["n_sites"]):
        raise SystemExit(
            f"cannot append {L}-site sequences to a "
            f"{prev['n_sites']}-site store: all sequences must be "
            "aligned")
    w2 = (L + 1) // 2
    if prev is not None:
        frames = bool(prev.get("has_rowxz"))

    if prev is not None:
        _truncate_to_meta(outp, prev, frames)
    mode = "ab" if prev is not None else "wb"
    f_packed = open(outp / "packed.bin", mode)
    f_names = open(outp / "names.bin", mode)
    f_dpos = open(outp / "delta_pos.bin", mode)
    f_dval = open(outp / "delta_val.bin", mode)
    f_runs = open(outp / "gapruns.bin", mode)
    f_epos = open(outp / "exc_pos.bin", mode)
    f_echr = open(outp / "exc_chr.bin", mode)
    f_rowxz = open(outp / "rowxz.bin", mode) if frames or prev is None \
        else None

    valid_parts: list[np.ndarray] = []
    name_lens: list[np.ndarray] = []
    run_counts: list[np.ndarray] = []
    exc_counts: list[np.ndarray] = []
    rowxz_lens: list[np.ndarray] = []
    blocks: list[tuple[int, int, int, int, int]] = []
    base: np.ndarray | None = None
    pos_off = val_off = 0
    n_rows = 0
    stats = IngestStats(n_sites=L)
    block_crcs: list[int] = []
    if prev is not None:
        n_rows = int(prev["n_rows"])
        # drop orphan entries a crashed append may have saved past the
        # committed meta (appended blocks always start at >= old n_rows)
        blocks = [tuple(int(x) for x in b)
                  for b in np.load(outp / "blocks.npy")
                  if int(b[0]) < n_rows]
        # per-block integrity CRCs (see verify): carry forward the
        # committed prefix; blocks of a pre-checksum store — or of an
        # older CRC composition — get the -1 "unknown" sentinel
        # (verify reports, never recomputes — append must stay
        # O(new rows))
        if (outp / "block_crc.npy").is_file() \
                and prev.get("crc") == CRC_SCHEME:
            old_crc = np.load(outp / "block_crc.npy")
            block_crcs = [int(c) for c in old_crc[: len(blocks)]]
        if len(block_crcs) < len(blocks):
            block_crcs += [-1] * (len(blocks) - len(block_crcs))
        # "ab" position is only defined after the first write: size the
        # existing delta sections directly
        pos_off = os.path.getsize(outp / "delta_pos.bin")
        val_off = os.path.getsize(outp / "delta_val.bin")
        if (outp / "base.bin").is_file():
            base = np.fromfile(outp / "base.bin", dtype=np.uint8)
    n_rows0 = n_rows

    # ref_ambiguity=1.0 -> min_valid 0: keep every record (no QC here)
    streamer = RefStreamer(paths, L, block, ref_ambiguity=1.0)
    # the one-pass block digest (csrc/host/fasta_io.cpp ufa_store_block),
    # or None without the native library
    digest_lib = native.get_lib()
    frame_pool = None
    for batch in streamer:
        n = batch.n
        codes = batch.codes[:n]
        raw = batch.raw[:n]

        if digest_lib is not None:
            # one native pass: pack + valid + gap runs + exceptions
            (packed, vcounts, runs, counts, epos, echr,
             ecnts) = _digest_block_native(digest_lib, raw, codes)
        else:
            packed = host.pack_codes(codes)
            vcounts = np.count_nonzero(codes, axis=1).astype(np.int32)
            runs, counts = _gap_runs(raw)
            decoded = DECODE_LUT[codes]
            decoded[raw == ord("-")] = ord("-")
            er, ec = np.nonzero(decoded != raw)
            epos, echr = ec.astype(np.uint32), raw[er, ec]
            ecnts = np.bincount(er, minlength=n).astype(np.int64)
        # block CRC (verify() recomputes the same composition, in this
        # order: packed, names, valid-as-int64, gapruns, exc_pos,
        # exc_chr, [rowxz frames], [delta pos, delta val]) — CRC_SCHEME
        packed_bytes = packed.tobytes()
        f_packed.write(packed_bytes)
        crc = zlib.crc32(packed_bytes)
        valid_parts.append(vcounts)
        names_bytes = b"".join(nm.encode("utf-8") for nm in batch.names)
        name_lens.append(np.array(
            [len(nm.encode("utf-8")) for nm in batch.names],
            dtype=np.int64))
        f_names.write(names_bytes)
        crc = zlib.crc32(names_bytes, crc)
        crc = zlib.crc32(np.ascontiguousarray(
            vcounts, dtype=np.int64).tobytes(), crc)
        runs_bytes = np.ascontiguousarray(runs).tobytes()
        f_runs.write(runs_bytes)
        crc = zlib.crc32(runs_bytes, crc)
        run_counts.append(counts)
        epos_bytes = np.ascontiguousarray(epos).tobytes()
        echr_bytes = np.ascontiguousarray(echr).tobytes()
        f_epos.write(epos_bytes)
        f_echr.write(echr_bytes)
        crc = zlib.crc32(echr_bytes, zlib.crc32(epos_bytes, crc))
        exc_counts.append(ecnts)

        # pre-compressed dump frames (see layout comment): preset 0 is
        # a one-time cost paid here so scan-time dumps are byte copies.
        # LZMACompressor releases the GIL, so a thread pool compresses
        # the block's rows concurrently (map preserves row order);
        # ~linear speedup on multicore ingest hosts, harmless on one
        if frames:
            import lzma
            if frame_pool is None:
                import concurrent.futures as cf
                frame_pool = cf.ThreadPoolExecutor(
                    max_workers=min(8, os.cpu_count() or 1))
            row_frames = list(frame_pool.map(
                lambda i: lzma.compress(
                    b">" + batch.names[i].encode("utf-8") + b"\n"
                    + raw[i].tobytes() + b"\n",
                    format=lzma.FORMAT_XZ, preset=0), range(n)))
            xz_lens = np.empty(n, dtype=np.int64)
            for i, frame in enumerate(row_frames):
                f_rowxz.write(frame)
                crc = zlib.crc32(frame, crc)
                xz_lens[i] = len(frame)
            rowxz_lens.append(xz_lens)

        # sparse delta vs the first block's majority (host.majority_code
        # docstring: any base is exact; a same-population base keeps the
        # diff lists small)
        if base is None:
            base = host.majority_code(codes)
        enc = host.delta_encode(codes, np.ones(n, dtype=bool), base)
        if enc is not None and enc[0].dtype != np.uint16:
            enc = None        # huge-L uint32 positions: store packed-only
        if enc is not None:
            pos, val = enc
            E = pos.shape[1]
            pos_bytes = np.ascontiguousarray(pos).tobytes()
            val_bytes = np.ascontiguousarray(val).tobytes()
            f_dpos.write(pos_bytes)
            f_dval.write(val_bytes)
            crc = zlib.crc32(val_bytes, zlib.crc32(pos_bytes, crc))
            blocks.append((n_rows, n, E, pos_off, val_off))
            pos_off += pos.nbytes
            val_off += val.nbytes
            stats.n_delta_blocks += 1
        else:
            blocks.append((n_rows, n, 0, 0, 0))
            stats.n_packed_blocks += 1
        block_crcs.append(crc)
        n_rows += n
        if progress is not None:
            progress(n_rows - n_rows0, time.time() - t0)

    if frame_pool is not None:
        frame_pool.shutdown()
    for fh in (f_packed, f_names, f_dpos, f_dval, f_runs, f_epos,
               f_echr, f_rowxz):
        if fh is not None:
            fh.close()

    def _save_np(name, arr):
        """Atomic .npy rewrite: an in-place np.save interrupted
        mid-write would corrupt an EXISTING array the old meta still
        points at."""
        tmp = outp / (name + ".tmp")
        np.save(tmp, arr)
        os.replace(str(tmp) + ".npy", outp / name)

    def _offsets(parts, name):
        """Cumulative ends over old + new rows: the existing ends array
        (clipped to the committed row count — a crashed append may have
        saved longer arrays than its meta) extended by this run's
        per-row lengths."""
        head = (np.load(outp / name)[: n_rows0 + 1] if prev is not None
                else np.zeros(1, dtype=np.int64))
        if not parts:
            return head
        tail = np.cumsum(np.concatenate(parts),
                         dtype=np.int64) + int(head[-1])
        return np.concatenate([head, tail])

    new_valid = (np.concatenate(valid_parts) if valid_parts
                 else np.empty(0, np.int32))
    if prev is not None:
        new_valid = np.concatenate([np.load(outp / "valid.npy")[:n_rows0],
                                    new_valid])
    _save_np("valid.npy", new_valid)
    _save_np("name_offsets.npy", _offsets(name_lens, "name_offsets.npy"))
    _save_np("gaprun_offsets.npy",
             _offsets(run_counts, "gaprun_offsets.npy"))
    _save_np("exc_offsets.npy", _offsets(exc_counts, "exc_offsets.npy"))
    if frames:
        _save_np("rowxz_offsets.npy",
                 _offsets(rowxz_lens, "rowxz_offsets.npy"))
    elif prev is None:
        os.unlink(outp / "rowxz.bin")
    _save_np("blocks.npy",
             np.asarray(blocks, dtype=np.int64).reshape(-1, 5))
    _save_np("block_crc.npy", np.asarray(block_crcs, dtype=np.int64))
    has_delta = stats.n_delta_blocks > 0 or bool(
        prev is not None and prev.get("has_delta"))
    if stats.n_delta_blocks and base is not None \
            and not (outp / "base.bin").is_file():
        # never rewrite an existing base: appended deltas are against
        # it bit-for-bit, and an interrupted rewrite would corrupt a
        # section the old meta already points at
        base.tofile(outp / "base.bin")

    meta = {"format": FORMAT, "version": VERSION, "crc": CRC_SCHEME,
            "n_rows": n_rows,
            "n_sites": L, "w2": w2,
            "block": int(prev["block"]) if prev is not None else block,
            "has_delta": has_delta,
            "has_rowxz": frames,
            "sources": (list(prev["sources"]) if prev is not None else [])
            + [str(p) for p in paths]}
    # the commit point: a crash anywhere above leaves the OLD meta
    # describing a valid prefix of every (append-only) section
    tmp = outp / "meta.json.tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh, indent=1)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, outp / "meta.json")

    stats.n_rows = n_rows - n_rows0      # rows ingested by THIS run
    stats.seconds = time.time() - t0
    stats.bytes = sum(
        (outp / f).stat().st_size for f in os.listdir(outp))
    return stats


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
        self._decode_checked = False
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

    def seq_rows(self, rows) -> list[bytes]:
        """``seq_row`` of each of ``rows`` (any order, repeats allowed),
        decoded in one call of the native library (csrc/host/fasta_io.cpp
        ``ufa_store_decode``), which holds no GIL; without the library,
        row by row through ``seq_row``.  Counts the rows the library
        decoded as ``bulk_decode_rows``."""
        from . import native
        rows = np.ascontiguousarray(rows, dtype=np.int64).reshape(-1)
        lib = native.get_lib()
        if lib is None or rows.size == 0:
            return [self.seq_row(int(r)) for r in rows]
        self._lazy_decode_meta()
        if not self._decode_checked:
            # the library trusts these bounds: check them once a store
            self._run_off = np.ascontiguousarray(self._run_off, np.int64)
            self._exc_off = np.ascontiguousarray(self._exc_off, np.int64)
            for off, n in ((self._run_off, len(self._runs)),
                           (self._exc_off, len(self._exc_pos))):
                if (len(off) != self.n_rows + 1 or off[0] < 0
                        or off[-1] > n or (np.diff(off) < 0).any()):
                    raise ValueError(f"{self.path}: damaged row offsets "
                                     f"(check the store: info --verify)")
            if len(self._exc_chr) != len(self._exc_pos) or \
                    2 * self.w2 < self.n_sites:
                raise ValueError(f"{self.path}: damaged store sections")
            self._decode_checked = True
        out = np.empty((rows.size, self.n_sites), dtype=np.uint8)

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p)
        if lib.ufa_store_decode(
                ptr(self.packed), self.w2, self.n_rows, ptr(rows),
                rows.size, self.n_sites, ptr(_DECODE_PAIRS),
                ptr(self._runs), ptr(self._run_off), ptr(self._exc_pos),
                ptr(self._exc_chr), ptr(self._exc_off), ptr(out)) != 0:
            raise IndexError(f"{self.path}: a row or an exception "
                             f"position lies outside the store")
        observe.count("bulk_decode_rows", rows.size)
        return [row.tobytes() for row in out]

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

    def seq_many(self, idx) -> list[bytes]:
        """``seq(i)`` of each i of ``idx``, one ``Store.seq_rows`` call
        a piece."""
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        out: list = [None] * idx.size
        lo = found = 0
        for store, rows in self.pieces:
            at = np.nonzero((idx >= lo) & (idx < lo + len(rows)))[0]
            if at.size:
                seqs = store.seq_rows(np.asarray(rows)[idx[at] - lo])
                for k, sq in zip(at.tolist(), seqs):
                    out[k] = sq
                found += at.size
            lo += len(rows)
        if found != idx.size:
            raise IndexError(idx[(idx < 0) | (idx >= lo)][0])
        return out

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
        self._pf = Prefetcher(
            lambda: observe.iter_spans("stream_read", self._batches()),
            maxsize=prefetch)

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
