"""Reference-based batch alignment (``uvaia align``, the ``uvaialign``
equivalent) on PyTorch — the counterpart of ``uvaia_tpu/engine/align.py``.

Read the reference, stream query FASTA files, QC-reject sequences too
different in length (outside [2/3, 3/2] x ref) or too ambiguous, align
each against the reference with affine-gap penalties {0,4,6,2}, project
onto reference coordinates (insertions dropped, deletions '-'), and
write an xz alignment or stdout — the same bytes as the JAX package.

The forward DP is the banded Gotoh kernel (ops/gotoh_kernels.py); bands
are routed per row from the length offset and widened when a row's
optimality certificate fails, up to --band, with a certificate-2 band
beyond it as the exact fallback.  The device is explicit
(``AlignConfig.device``): on ``cuda`` the forward runs in the
hand-written kernel, and a missing GPU is an error, never a CPU run.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..core.encoding import composition, encode, strict_chars_check
from ..io.fasta import FastaRecord, make_fasta_writer, read_fasta
from ..ops import gotoh
from ..utils import observe
from ..utils.observe import maybe_profile
from ..utils.prefetch import Prefetcher
from .nearest import resolve_device
from .query import log


@dataclass
class AlignConfig:
    ambiguity: float = 0.5
    pool: int = 1024              # queries aligned per device batch
    band: int = 1024              # max band width before giving up
    slack: int = 64               # band slack beyond the length offset
    exact_fallback: bool = True   # rows the --band cap cannot certify
                                  # re-align once at the certificate-2
                                  # band (beyond --band, chunked to the
                                  # tb budget) so every emitted row is
                                  # provably optimal; False accepts them
                                  # uncertified (WFA-Adapt parity)
    to_stdout: bool = False
    output: str | None = None
    print_interval: int = 5000
    codec: str = "xz"             # output compression: xz/bz2/gz/raw
    device: str = "cuda"          # "cuda" (kernel) or "cpu" (plain)

    @property
    def prefix(self) -> str:
        return self.output if self.output else "uvaia_tpu_align"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _choose_band(n: int, lens: list[int], slack: int) -> tuple[int, int]:
    """(lo, width) covering all length offsets plus slack, quantised to
    limit the number of distinct shapes."""
    d_min = min(min(l - n for l in lens), 0) - slack
    d_max = max(max(l - n for l in lens), 0) + slack
    lo = -_round_up(-d_min, 32)
    width = _round_up(d_max - lo + 1, 64) + 1
    return lo, width


@dataclass
class AlignStats:
    count: int = 0
    n_output: int = 0
    rejected_length: int = 0
    rejected_ambiguity: int = 0
    failed_band: int = 0
    uncertified: int = 0     # emitted but optimality not provable
                             # within the band cap (WFA-Adapt parity)
    uncertified_names: list = None   # their names, for the audit sidecar
    exact_certified: int = 0  # rows certified by the beyond-cap
                              # certificate-2 fallback band

    def mark_uncertified(self, name: str) -> None:
        self.uncertified += 1
        if self.uncertified_names is None:
            self.uncertified_names = []
        self.uncertified_names.append(name)


def _qc(rec: FastaRecord, n: int, ambiguity: float, stats: AlignStats) -> bool:
    m = len(rec.seq)
    if 3 * m < 2 * n or 2 * m > 3 * n:
        log(f"Sequence {rec.name} has size too different from reference "
            f"({m} vs {n})")
        stats.rejected_length += 1
        return False
    strict_chars_check(rec.name, rec.seq)
    acgt, _amb, other = composition(encode(rec.seq))
    if other > ambiguity:
        log(f"Sequence {rec.name} has proportion of N etc. (={other:f}) "
            f"above threshold of {ambiguity:f}")
        stats.rejected_ambiguity += 1
        return False
    if acgt < 1.0 - 1.1 * ambiguity:
        log(f"Sequence {rec.name} has proportion of ACGT (={acgt:f}) below "
            f"threshold of {1.0 - 1.1 * ambiguity:f}")
        stats.rejected_ambiguity += 1
        return False
    return True


# traceback buffer cap (bytes): B * n * W.  The effective cap is
# min(TB_BUDGET, 2^31 - 1): the traceback walks index the buffer with
# flat offsets that the JAX package computes in int32, and the port
# keeps its chunking so both packages align the same groups.
TB_BUDGET = 6 << 30
TB_IDX_CAP = (1 << 31) - 1
E_DIFF = 1024           # sparse D2H: max (pos, char) diffs per row


def _pack_rows(recs, b_mult: int = 64):
    """(arr (B_pad, m_pad) uint8, lens (B_pad,) int32) with the batch
    axis padded to a multiple of b_mult (duplicating row 0) and m_pad
    quantised to 256."""
    B = len(recs)
    B_pad = _round_up(B, b_mult)
    m_pad = _round_up(max(len(r.seq) for r in recs), 256)
    arr = np.zeros((B_pad, m_pad), dtype=np.uint8)
    lens = np.zeros(B_pad, dtype=np.int32)
    for b, r in enumerate(recs):
        arr[b, :len(r.seq)] = np.frombuffer(r.seq, dtype=np.uint8)
        lens[b] = len(r.seq)
    arr[B:] = arr[0]
    lens[B:] = lens[0]
    return arr, lens


@dataclass
class _DeviceBatch:
    """One flush's query rows, uploaded to the device once; groups and
    escalations take device-side row gathers instead of re-uploading."""
    ref_arr: np.ndarray        # (n,) host reference bytes
    ref_d: torch.Tensor        # device copy
    lens: np.ndarray           # (B_all,) host query lengths
    arr_d: torch.Tensor        # (B_all, m_pad) device query bytes
    lens_d: torch.Tensor


def _unpack4(packed: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of the 4-bit host pack: (B, m/2) nibble
    pairs + a 16-entry byte LUT -> (B, m) raw query bytes."""
    hi = lut[(packed >> 4).long()]
    lo = lut[(packed & 15).long()]
    B, m2 = packed.shape
    return torch.stack([hi, lo], dim=2).reshape(B, m2 * 2)


@observe.span("upload")
def _make_device_batch(ref_arr, recs, device) -> _DeviceBatch:
    arr, lens = _pack_rows(recs)
    up = lambda a: torch.from_numpy(np.require(a, requirements="CW")).to(
        device)
    # when the batch uses <= 16 distinct byte values (ACGT + IUPAC
    # ambiguity — the universal case for QC-passed genomes), ship 4-bit
    # indices + a LUT and unpack on the device, halving the upload
    present = np.zeros(256, dtype=bool)
    present[arr.reshape(-1)] = True
    # byte 0 appears only as row padding (FASTA bytes are ASCII
    # letters) and the DP masks past each row's length, so it need not
    # burn one of the 16 LUT slots: it aliases to vals[0]
    present[0] = False
    vals = np.nonzero(present)[0].astype(np.uint8)
    if 0 < len(vals) <= 16:
        table = np.zeros(256, dtype=np.uint8)
        table[vals] = np.arange(len(vals), dtype=np.uint8)
        idx = table[arr]
        packed = (idx[:, 0::2] << 4) | idx[:, 1::2]
        lut = np.zeros(16, dtype=np.uint8)
        lut[:len(vals)] = vals
        arr_d = _unpack4(up(packed), up(lut))
    else:
        arr_d = up(arr)
    return _DeviceBatch(ref_arr=ref_arr, ref_d=up(ref_arr), lens=lens,
                        arr_d=arr_d, lens_d=up(lens))


def _pad_idx(db: _DeviceBatch, idxs: list[int], b_mult: int = 64):
    """Row-index vector padded to a b_mult-multiple (+ its host lens)."""
    B_pad = _round_up(len(idxs), b_mult)
    idx = np.full(B_pad, idxs[0], dtype=np.int64)
    idx[:len(idxs)] = idxs
    return torch.from_numpy(idx).to(db.arr_d.device), db.lens[idx]


def _chunk_plan(n: int, width: int) -> tuple[int, int]:
    """(max_rows, b_mult) for one dispatch chunk at this (n, width),
    as uvaia_tpu.engine.align._chunk_plan: the padded batch keeps
    B_pad * n_p * w_p < 2^31 with n and width padded to 128.  b_mult
    == 0 means even one padded row overflows: the row cannot be
    tracebacked at this (n, width) and must be skipped."""
    n_p = -(-n // 128) * 128
    w_p = -(-width // 128) * 128
    cap = min(TB_BUDGET, TB_IDX_CAP) // max(n_p * w_p, 1)
    b_mult = max((b for b in (64, 32, 16, 8, 1) if b <= cap), default=0)
    if b_mult == 0:
        return 0, 0
    return cap - cap % b_mult, b_mult


def _dispatch_group(db: _DeviceBatch, items, lo, width, stats,
                    redo: bool = False):
    """Run one group's aligner, split so the traceback buffer (B*n*W
    bytes on the device) stays under budget.  Returns a list of pending
    (items, lens, meta_dev, lo, width) tuples.  `redo`: the rows were
    dispatched before (an escalation or the certificate-2 fallback)."""
    n = db.ref_arr.shape[0]
    max_rows, b_mult = _chunk_plan(n, width)
    if max_rows == 0:
        for r, _ in items:
            log(f"Sequence {r.name}: band {width} at reference length "
                f"{n} exceeds the traceback index budget; skipped")
            stats.failed_band += 1
        return []
    pending = []
    for start in range(0, len(items), max_rows):
        part = items[start:start + max_rows]
        idx_d, lens = _pad_idx(db, [i for _, i in part], b_mult)
        meta_d = gotoh.align_rows(
            db.ref_d, db.arr_d, db.lens_d, idx_d, lo, width, gotoh.EV_CAP)
        pending.append((part, lens, meta_d, lo, width))
    observe.count("redo_rows" if redo else "forward_rows", len(items))
    observe.count("forward_cells", len(items) * n * width)
    return pending


def _collect_group(db: _DeviceBatch, handle, out, stats, cfg,
                   exact: bool = False):
    """Fetch one pending group's output buffer and emit rows; escalate
    the band (synchronously — rare) for rows that escape.  ``exact``
    marks a certificate-2 fallback pass (see _exact_fallback): its band
    provably covers the optimum, so rows certify here and no further
    fallback recursion happens."""
    items, lens, meta_d, lo, width = handle
    ref_arr = db.ref_arr
    n = ref_arr.shape[0]
    recs = [r for r, _ in items]
    with observe.span("device_wait"):
        meta = meta_d.cpu().numpy()
    (score, edge_min, done, cnt, ovf, t_end, ev_i,
     ev_t) = gotoh.unpack_meta_events(meta, gotoh.EV_CAP)
    walk_cost = np.full(score.shape[0], -1, dtype=np.int64)
    row_cache: dict[int, bytes] = {}
    dense = []
    with observe.span("decode"):
        for i in range(len(recs)):
            if not done[i]:
                continue               # fails certify -> band escalation
            if ovf[i]:
                dense.append(i)
                continue
            q = np.frombuffer(recs[i].seq, dtype=np.uint8)
            row, cost = gotoh.decode_events(q, ref_arr, int(t_end[i]), lo,
                                            ev_i[i], ev_t[i], int(cnt[i]))
            if row is None:
                dense.append(i)
            else:
                row_cache[i] = row.tobytes()
                walk_cost[i] = cost
    if dense:
        # event-capacity overflow (> EV_CAP kind changes, i.e. > 96 gap
        # runs — pathological rows): dense per-character walk fallback,
        # with the dispatch's padded-batch index budget
        with observe.span("dense"):
            _, b_mult = _chunk_plan(n, width)
            idx_d, _ = _pad_idx(db, [items[i][1] for i in dense], b_mult)
            meta2, aligned2 = gotoh.align_rows_dense(
                db.ref_d, db.arr_d, db.lens_d, idx_d, lo, width, E_DIFF)
            with observe.span("device_wait"):
                meta2 = meta2.cpu().numpy()
            (_s2, _e2, _d2, wc2, count2, pos2,
             chars2) = gotoh.unpack_meta(meta2, E_DIFF)
            for k, i in enumerate(dense):
                walk_cost[i] = wc2[k]
                if count2[k] <= E_DIFF:
                    row = ref_arr.copy()
                    row[pos2[k, :count2[k]]] = chars2[k, :count2[k]]
                    row_cache[i] = row.tobytes()
                else:
                    row_cache[i] = aligned2[k].cpu().numpy().tobytes()
        observe.count("dense_rows", len(dense))
        observe.count("forward_cells", len(dense) * n * width)
    with observe.span("decode"):
        ok, consistent, wander = gotoh.certify(
            score, edge_min, done, walk_cost, lens, n, lo, width)

    retry, exact_items = [], []

    def accept_or_exact(i):
        """A consistent row the --band cap cannot certify: re-align at
        the certificate-2 band (default) or accept uncertified
        (WFA-Adapt parity / already in the exact pass)."""
        if exact or not cfg.exact_fallback:
            stats.mark_uncertified(recs[i].name)
            out[id(recs[i])] = row_cache[i]
        else:
            exact_items.append((items[i], row_cache[i], int(wander[i])))

    for i in range(len(recs)):
        if ok[i]:
            if exact:
                stats.exact_certified += 1
            out[id(recs[i])] = row_cache[i]
        elif consistent[i] and 2 * wander[i] + abs(len(recs[i].seq) - n) \
                > cfg.band:
            accept_or_exact(i)
        else:
            retry.append(i)
    if retry:
        # escalate up to (never beyond) the configured cap
        new_width = min(width * 4, cfg.band)
        if new_width <= width:
            for i in retry:
                if consistent[i]:
                    accept_or_exact(i)
                else:
                    log(f"Sequence {recs[i].name}: no alignment within "
                        f"band {width}; skipped")
                    stats.failed_band += 1
        else:
            new_lo = lo - (new_width - width) // 2
            with observe.span("escalate"):
                _align_group(db, [items[i] for i in retry],
                             new_lo, new_width, out, stats, cfg)
    if exact_items:
        with observe.span("exact"):
            _exact_fallback(db, exact_items, out, stats, cfg)


def _exact_fallback(db: _DeviceBatch, ex_items, out, stats, cfg):
    """Re-align rows the --band cap could not certify at their
    certificate-2 band — the hull of end diagonals widened by the
    wander bound (gotoh.certify), which provably contains the global
    optimum — even when that band exceeds --band.  A row whose
    certified band cannot fit even one chunk keeps the consistent
    banded alignment and stays in the uncertified sidecar."""
    n = db.ref_arr.shape[0]
    groups: dict[tuple[int, int], list] = {}
    for (rec, bi), row, wd in ex_items:
        d_end = len(rec.seq) - n
        lo_i = min(0, d_end) - wd - 16
        hi_i = max(0, d_end) + wd + 16
        # quantise so repeated fallbacks share band shapes
        lo_q = -_round_up(-lo_i, 256)
        w_q = _round_up(hi_i - lo_q + 1, 1024) + 1
        if _chunk_plan(n, w_q)[1] == 0:
            stats.mark_uncertified(rec.name)
            out[id(rec)] = row
        else:
            groups.setdefault((lo_q, w_q), []).append((rec, bi))
    for (lo_q, w_q), gitems in groups.items():
        _align_group(db, gitems, lo_q, w_q, out, stats, cfg, exact=True)


def _align_group(db: _DeviceBatch, items, lo, width, out, stats, cfg,
                 exact: bool = False):
    """Synchronous dispatch + collect of rows dispatched before
    (escalations, the certificate-2 fallback)."""
    for handle in _dispatch_group(db, items, lo, width, stats, redo=True):
        _collect_group(db, handle, out, stats, cfg, exact=exact)


def _band_levels(band: int) -> list[int]:
    """Canonical zero-centred band half-widths: 64, 128, ... capped by
    the --band budget."""
    levels = []
    h = 64
    while h * 2 + 1 <= max(band, 129):
        levels.append(h)
        h *= 2
    return levels or [64]


ROUTE_MARGIN = 16   # extra half-band beyond |len offset| when routing


def run_align(ref_path: str, fasta_paths: list[str], cfg: AlignConfig):
    with maybe_profile(), observe.job("align", log) as root:
        return _run_align(ref_path, fasta_paths, cfg, root)


def _run_align(ref_path: str, fasta_paths: list[str], cfg: AlignConfig,
               root: observe.Span):
    dev = resolve_device(cfg.device)
    with observe.span("reference"):
        try:
            ref = next(iter(read_fasta(ref_path)))
        except StopIteration:
            raise SystemExit(f"Error reading reference sequence {ref_path}")
    n = len(ref.seq)
    ref_arr = np.frombuffer(ref.seq, dtype=np.uint8)
    log(f"Reference {ref.name}: {n} sites")

    writer = None
    if not cfg.to_stdout:
        with observe.span("write"):
            writer = make_fasta_writer(cfg.prefix + ".aln", cfg.codec)
        log(f"Sequences will be compressed and saved into file "
            f"{writer.path}.")

    stats = AlignStats()

    @observe.span("dispatch")
    def dispatch_pool(batch):
        """Upload one pool and run its aligners.  Each row is routed to
        a canonical zero-centred band bucket from its length offset
        alone; certify in _collect_group is the soundness gate (a row
        whose optimum wanders beyond its routed band escalates)."""
        db = _make_device_batch(ref_arr, batch, dev)   # single upload
        levels = _band_levels(cfg.band)
        buckets: dict[int, list] = {}
        cap_rows: list = []
        for bi, r in enumerate(batch):
            d = abs(len(r.seq) - n)
            for h in levels:
                if d + ROUTE_MARGIN <= h:
                    buckets.setdefault(h, []).append((r, bi))
                    break
            else:
                cap_rows.append((r, bi))
        pending = []
        for h, bitems in sorted(buckets.items()):
            pending += _dispatch_group(db, bitems, -h, 2 * h + 1, stats)
        # rows whose length offset exceeds every canonical band get a
        # structural band covering their end diagonals (grouped by
        # offset so mixed groups don't inflate W)
        cap_groups: dict[int, list] = {}
        for r, bi in cap_rows:
            cap_groups.setdefault((len(r.seq) - n) // 256,
                                  []).append((r, bi))
        for items in cap_groups.values():
            lo, width = _choose_band(n, [len(r.seq) for r, _ in items],
                                     cfg.slack)
            pending += _dispatch_group(db, items, lo, width, stats)
        return db, pending, batch

    @observe.span("collect")
    def collect_pool(handle):
        """The pool's rows in input order: (record, aligned bytes) of
        every row that aligned."""
        db, pending, batch = handle
        out: dict[int, bytes] = {}
        for h in pending:
            _collect_group(db, h, out, stats, cfg)
        return [(r, out[id(r)]) for r in batch if id(r) in out]

    @observe.span("write")
    def write_rows(rows):
        for r, seq in rows:
            if cfg.to_stdout:
                sys.stdout.write(f">{r.name}\n{seq.decode('ascii')}\n")
            else:
                writer.write(r.name, seq)
        stats.n_output += len(rows)

    # Reader thread: read + QC the next pool while the current one
    # aligns; the main loop keeps one pool dispatched ahead of the one
    # whose results it collects.
    def _pools():
        batch: list[FastaRecord] = []
        last_print = 0
        for path in fasta_paths:
            log(f"Started  reading file {path}")
            for rec in read_fasta(path):
                if reader.aborted():
                    return
                stats.count += 1
                if not _qc(rec, n, cfg.ambiguity, stats):
                    continue
                batch.append(rec)
                if len(batch) >= cfg.pool:
                    yield batch
                    batch = []
                if stats.count - last_print >= cfg.print_interval:
                    last_print = stats.count
                    log(f"{stats.count}\t sequences read, "
                        f"{stats.n_output} \taligned. "
                        f"{root.seconds():.3f} secs elapsed.")
            log(f"Finished reading file {path}.")
        if batch:
            yield batch

    reader = Prefetcher(lambda: observe.iter_spans("read_qc", _pools()),
                        maxsize=2)
    prev = None
    for batch in observe.iter_spans("read_wait", reader):
        cur = dispatch_pool(batch)
        if prev is not None:
            write_rows(collect_pool(prev))
        prev = cur
    if prev is not None:
        write_rows(collect_pool(prev))

    if writer is not None:
        with observe.span("writer_close"):
            writer.close()
        log(f"Saved {stats.n_output} sequences to file {writer.path}")
    for name, k in (("rows_read", stats.count),
                    ("rows_rejected",
                     stats.rejected_length + stats.rejected_ambiguity),
                    ("uncertified_rows", stats.uncertified),
                    ("failed_rows", stats.failed_band)):
        observe.count(name, k)
    counts = root.counts
    if stats.uncertified_names:
        # audit sidecar: rows accepted without an optimality certificate
        side = cfg.prefix + ".uncertified.txt"
        with open(side, "w") as fh:
            fh.write("\n".join(stats.uncertified_names) + "\n")
        log(f"Wrote {counts['uncertified_rows']} uncertified sequence "
            f"names to {side} (alignments emitted, optimality not "
            f"provable within --band)")
    log(f"Total: {counts['rows_read']} read, {stats.n_output} aligned, "
        f"{stats.rejected_length} wrong length, "
        f"{stats.rejected_ambiguity} too ambiguous, "
        f"{stats.exact_certified} certified beyond --band, "
        f"{counts['uncertified_rows']} uncertified (band cap), "
        f"{counts['failed_rows']} failed. "
        f"{root.seconds():.3f} secs total.")
    return stats
