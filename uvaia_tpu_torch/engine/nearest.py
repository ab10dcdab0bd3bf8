"""Streaming exact nearest-neighbour search (``uvaia nearest``) on
PyTorch — the counterpart of ``uvaia_tpu/engine/nearest.py``: full mode
or --acgt, the prune prefilter on or off, on one device or sharded over
a (db, site) mesh of devices (``n_devices``, ``site_shards``;
parallel/mesh.py).  Several processes, each scanning its share, are
parallel/multihost.py's.

Read queries -> QC -> site classes -> stream the database in batches
(sparse-delta or 4-bit packed uploads) -> rebuild the codes on the
device -> prune -> exact six scores -> per-query top-k -> append-dump
close references -> ranked CSV.  Outputs (same bytes as the JAX
package):
  <prefix>.aln.xz — every reference that at some point entered a best
                    set (superset of the final neighbours)
  <prefix>.csv.xz — ranked table: query,reference,rank + six scores

The device is explicit (``NearestConfig.device``): on ``cuda`` every
integer pass runs in the hand-written kernels, and a missing GPU is an
error, never a silent CPU run.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..io.compress import open_write
from ..io.fasta import WRITE_CODEC_SUFFIX, make_fasta_writer
from ..ops import scan
from ..ops.host import IDX_SENTINEL, majority_code
from ..ops.score_kernels import full_float32_matmuls
from ..parallel import mesh as pmesh
from ..utils import checkpoint as ckpt_mod
from ..utils import observe
from ..utils.observe import maybe_profile
from .query import QueryPack, build_query_pack, log
from .stream import (dump_entries, dump_entry, open_reference_stream,
                     write_dump)

CSV_HEADER_FULL = ("query,reference,rank,ACGT_matches,text_matches,"
                   "partial_matches,valid_pair_comparisons,"
                   "ACGT_matches_unique,valid_ref_sites\n")
CSV_HEADER_ACGT = ("query,reference,rank,ACGT_matches,"
                   "valid_ACGT_comparisons,ACGT_matches_unique,"
                   "valid_ref_sites,dist_consensus,dist_unique\n")

@dataclass
class NearestConfig:
    nbest: int = 100
    trim: int = 0
    acgt: bool = False               # --acgt: ACGT differences only
    keep_resolved: bool = False
    exclude_self: bool = False
    query_ambiguity: float = 0.5
    ref_ambiguity: float = 0.5
    pool: int = 4096                 # refs per device batch
    output: str | None = None
    print_interval: int = 10000
    n_devices: int | None = None     # > 1: shard the scan over a 'db' axis
    site_shards: int = 1             # and the sites over a 'site' axis
    checkpoint: str | None = None    # snapshot path (resume if it exists)
    checkpoint_every: float = 60.0   # seconds between snapshots
    codec: str = "xz"                # output compression: xz/bz2/gz/raw
    prune: bool = True               # two-phase upper-bound prefilter
    skip_records: int = 0            # raw-record window [skip, limit)
    limit_records: int = 0           # (limit requires store inputs)
    device: str = "cuda"             # "cuda" (kernels) or "cpu" (plain)

    def clamp(self) -> "NearestConfig":
        self.query_ambiguity = min(max(self.query_ambiguity, 0.001), 1.0)
        self.ref_ambiguity = min(max(self.ref_ambiguity, 0.001), 1.0)
        self.nbest = max(self.nbest, 1)
        self.pool = max(self.pool, 8)
        return self

    @property
    def prefix(self) -> str:
        if self.output:
            return self.output
        return "nn_uvaia_acgt" if self.acgt else "nn_uvaia"


@dataclass
class NearestResult:
    pack: QueryPack
    scores: np.ndarray            # (Q, k, 6)
    indices: np.ndarray           # (Q, k) global db index or sentinel
    names: dict[int, str]         # db index -> reference name
    n_scanned: int = 0
    n_saved: int = 0
    n_invalid: int = 0
    same_name: int = 0

    def rows(self):
        """Yield CSV rows (query, ref, rank, s0..s5)."""
        for qi, qname in enumerate(self.pack.names):
            rank = 0
            for slot in range(self.indices.shape[1]):
                ri = int(self.indices[qi, slot])
                if ri == int(IDX_SENTINEL):
                    break
                rank += 1
                yield (qname, self.names.get(ri, f"db_{ri}"), rank,
                       *map(int, self.scores[qi, slot]))

    def write_csv(self, path: str) -> None:
        n = 0
        with open_write(path) as fh:
            fh.write((CSV_HEADER_ACGT if self.pack.acgt
                      else CSV_HEADER_FULL).encode())
            for row in self.rows():
                q, r, rank, *s = row
                fh.write((f"{q},{r},{rank}," +
                          ",".join(map(str, s)) + "\n").encode())
                n += 1
        observe.count("csv_rows", n)
        observe.count("csv_bytes", os.path.getsize(path))


def count_upload(payload) -> None:
    """The job's counters of a batch's upload: the batch, and a sparse
    delta's batch, B rows and B x E slots, or a 4-bit packed batch."""
    observe.count("batches", 1)
    if payload[0] == "delta":
        B, E = payload[1].shape
        observe.count("delta_batches", 1)
        observe.count("delta_rows", B)
        observe.count("delta_slots", B * E)
    else:
        observe.count("packed_batches", 1)


def resolve_device(name: str) -> torch.device:
    """The run's device; a CUDA request without a usable GPU exits."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to "
            "run the plain PyTorch versions on the CPU")
    return dev


def make_run_mesh(cfg: NearestConfig, dev: torch.device):
    """The (db, site) mesh of a sharded run (n_devices > 1; site_shards
    is ignored otherwise, as in uvaia_tpu), or None.  Refuses a
    site_shards that does not divide n_devices, and a mesh larger than
    the visible devices of dev's type."""
    if not (cfg.n_devices and cfg.n_devices > 1):
        return None
    if cfg.site_shards < 1 or cfg.n_devices % cfg.site_shards:
        raise SystemExit(
            f"--site-shards {cfg.site_shards} must divide "
            f"--devices {cfg.n_devices} (mesh is db x site)")
    try:
        return pmesh.make_mesh(cfg.n_devices // cfg.site_shards,
                               cfg.site_shards, device_type=dev.type)
    except ValueError as e:
        raise SystemExit(f"--devices {cfg.n_devices}: {e}")


def _up(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    observe.count("h2d_bytes", x.nbytes)
    return scan.upload(x, dev)


def _fetch(t: torch.Tensor) -> np.ndarray:
    """A device result on the host (blocks until it is ready)."""
    with observe.span("device_wait"):
        return t.cpu().numpy()


class _Mode:
    """A way to scan, for _run_nearest's loop: ``step`` queues a batch's
    device work (its flags are read later), ``settle`` is the host work
    due after it, ``snapshot`` brings dump and state to one batch (before
    the step if ``snapshot_first``), ``finish`` drains what is left."""

    snapshot_first = False

    def __init__(self, qd, state, dump, dev: torch.device):
        self.qd, self.state, self.dump, self.dev = qd, state, dump, dev
        self.pending = None     # (device flags, batch) drained one behind

    def up(self, x: np.ndarray) -> torch.Tensor:
        return _up(x, self.dev)

    def ref_idx(self, batch, payload) -> torch.Tensor:
        return self.up(batch.base_idx + np.arange(payload[1].shape[0],
                                                  dtype=np.int32))

    def host_state(self):
        return _fetch(self.state[0]), _fetch(self.state[1])

    def snapshot(self, batch):
        self.finish()
        return batch, self.host_state()


class _Dense(_Mode):
    """--no-prune: every batch scored whole (on a mesh, sharded).  Flags
    drain one batch behind; a snapshot holds the state from before step
    i with the drain of batch i-1."""

    snapshot_first = True

    def __init__(self, qd, state, dump, dev, mesh):
        super().__init__(qd, state, dump, dev)
        self.sharded = None if mesh is None else (
            pmesh.make_sharded_scan_step(qd, mesh),
            pmesh.make_sharded_scan_step(qd, mesh, delta=True))

    def step(self, batch, payload):
        ok, delta = self.up(batch.ok), payload[0] == "delta"
        if self.sharded is None:    # rows: the batch's first global index
            fn = scan.scan_step_delta if delta else scan.scan_step_packed
            fn, rows = partial(fn, self.qd), batch.base_idx
        else:                       # rows: every row's global index
            fn, rows = self.sharded[delta], self.ref_idx(batch, payload)
        self.state, flags = fn(self.state, *map(self.up, payload[1:]), ok,
                               rows)
        return flags

    def settle(self, batch, flags):
        self.finish()
        self.pending = (flags, batch)

    def snapshot(self, batch):
        if self.pending is not None:
            return self.pending[1], self.host_state()

    def finish(self):
        if self.pending is not None:
            (flags, batch), self.pending = self.pending, None
            hit = np.nonzero(_fetch(flags)[: batch.n])[0]
            self.dump((batch.base_idx + int(i), dump_entry(batch, int(i)))
                      for i in hit)


class _Survivors(_Mode):
    """Two-phase: the device prunes batches into survivor buffers, a
    flush scores them; the host dumps the survivors a flush flags."""

    def __init__(self, qd, state, dump, dev, pack):
        super().__init__(qd, state, dump, dev)
        scan.build_prune_data(qd, pack)
        self.retained: dict[int, tuple] = {}

    def retain(self, batch, survive) -> int:
        sv = np.nonzero(_fetch(survive)[: batch.n])[0]
        with observe.span("retain"):
            self.retained.update(zip((batch.base_idx + sv).tolist(),
                                     dump_entries(batch, sv)))
        observe.count("rows_scored", len(sv))
        return len(sv)

    def dump_flagged(self, idx) -> None:
        self.dump((int(g), self.retained[int(g)]) for g in idx)
        self.retained = {}


class _Prune(_Survivors):
    """On one device, survivors drained one batch behind.  The buffer
    (~1 GB, at least two batches) is flushed when it could overflow, and
    on the first batch: thresholds tighten only at flushes."""

    def __init__(self, qd, state, dump, dev, pack, pool: int):
        super().__init__(qd, state, dump, dev, pack)
        self.pool, W = pool, qd.width
        self.cap = max(2 * pool, min(8 * pool, (1 << 30) // max(W, 1)))
        self.buf, self.buf_idx, self.buf_n = scan.new_survivor_buffer(
            self.cap, W, dev)
        self.warmed_up = False
        self.n_buf_host = 0      # lagged host mirror of buf_n (see settle)

    def step(self, batch, payload):
        ok = self.up(batch.ok)
        fn = (scan.prune_and_hold_delta if payload[0] == "delta"
              else scan.prune_and_hold)
        survive, codes_d = fn(self.qd, self.state,
                              *map(self.up, payload[1:]), ok)
        scan.accumulate_survivors(self.buf, self.buf_idx, self.buf_n,
                                  codes_d, survive, batch.base_idx)
        return survive

    def drain(self):
        if self.pending is not None:
            (survive, batch), self.pending = self.pending, None
            self.n_buf_host += self.retain(batch, survive)

    def settle(self, batch, survive):
        self.drain()                  # sync batch i-1, not i
        self.pending = (survive, batch)
        # after the drain n_buf_host covers through batch i-1 and the
        # buffer through batch i: if n_buf_host + 2*pool <= cap, a fully
        # surviving batch i plus the NEXT batch still fit
        if not self.warmed_up or self.n_buf_host + 2 * self.pool > self.cap:
            self.flush()
            self.warmed_up = True

    def flush(self):
        self.drain()
        if self.n_buf_host == 0:
            self.retained = {}
            return
        with observe.span("flush"):
            self.state, flags = scan.flush_survivors(
                self.qd, self.state, self.buf, self.buf_idx, self.buf_n)
        observe.count("flushes", 1)
        flags = _fetch(flags)
        self.dump_flagged(_fetch(self.buf_idx)[np.nonzero(flags)[0]])
        self.buf_n.zero_()
        self.n_buf_host = 0

    finish = flush


class _ShardedPrune(_Survivors):
    """On a (db, site) mesh, a buffer a db shard; survivors read at once,
    and a flush whenever the fullest buffer could overflow on the next
    batch (rows past a shard's buffer end would be lost)."""

    def __init__(self, qd, state, dump, dev, pack, mesh, pool: int):
        super().__init__(qd, state, dump, dev, pack)
        self.B_loc = pool // mesh.shape["db"]
        self.cap_loc = 2 * self.B_loc
        init, self.prune_acc, self.prune_acc_delta, self.sv_flush = \
            pmesh.make_sharded_survivor_ops(qd, mesh, self.cap_loc)
        self.bufs = init()

    def step(self, batch, payload):
        ok, ridx = self.up(batch.ok), self.ref_idx(batch, payload)
        fn = (self.prune_acc_delta if payload[0] == "delta"
              else self.prune_acc)
        survive, self.bufs = fn(self.state, self.bufs,
                                *map(self.up, payload[1:]), ok, ridx)
        return survive

    def settle(self, batch, survive):
        self.retain(batch, survive)
        with observe.span("device_wait"):
            fullest = int(self.bufs.fill().max())
        if fullest + self.B_loc > self.cap_loc:
            self.flush()

    def flush(self):
        if not self.retained:
            return
        with observe.span("device_wait"):
            idxs = self.bufs.indices()
        with observe.span("flush"):
            self.state, flags, _ = self.sv_flush(self.state, self.bufs)
        observe.count("flushes", 1)
        self.dump_flagged(idxs[np.nonzero(_fetch(flags))[0]])

    finish = flush


def run_nearest(ref_paths: list[str], query_path: str,
                cfg: NearestConfig) -> NearestResult:
    # prune_step's site product runs as a float32 matmul, exact only in
    # full float32 precision (score_kernels.exact_counts)
    with maybe_profile(), full_float32_matmuls(), \
            observe.job("nearest", log) as root:
        return _run_nearest(ref_paths, query_path, cfg, root)


def _run_nearest(ref_paths: list[str], query_path: str,
                 cfg: NearestConfig, root: observe.Span) -> NearestResult:
    dev = resolve_device(cfg.device)
    cfg.clamp()
    mesh = make_run_mesh(cfg, dev)
    if mesh is not None:
        n_db = mesh.shape["db"]
        cfg.pool = -(-cfg.pool // n_db) * n_db   # round up to divide evenly
        dev = mesh.lead
    with observe.span("query_pack") as sp:
        pack = build_query_pack(query_path, trim=cfg.trim, acgt=cfg.acgt,
                                ambiguity=cfg.query_ambiguity,
                                keep_resolved=cfg.keep_resolved)
    log(f"Prepared {pack.n_query} query sequences in "
        f"{sp.seconds():.2f}s; scanning with top-k={cfg.nbest}, "
        f"batch={cfg.pool}")
    if cfg.acgt:
        log("Considering ACGT differences only "
            "(excluding all other characters).")
    else:
        log("Considering text match and partially ambiguous "
            "(excluding only gaps and Ns).")

    with observe.span("device_data"):
        if mesh is not None:
            log(f"Sharded scan over mesh (db={n_db}, site={cfg.site_shards})")
        # ---- checkpoint / resume (same key and file format as uvaia_tpu,
        # so either package resumes the other's snapshot) ------------------
        ckpt_key = ckpt_mod.config_key(
            refs=list(ref_paths), query=query_path, nbest=cfg.nbest,
            trim=cfg.trim, acgt=cfg.acgt, keep_resolved=cfg.keep_resolved,
            exclude_self=cfg.exclude_self, qa=cfg.query_ambiguity,
            ra=cfg.ref_ambiguity, n_query=pack.n_query,
            skip=cfg.skip_records, limit=cfg.limit_records, codec=cfg.codec)
        ckpt = ckpt_mod.load(cfg.checkpoint) if cfg.checkpoint else None
        if ckpt is not None and ckpt.config_key != ckpt_key:
            raise SystemExit(f"checkpoint {cfg.checkpoint} was written by a "
                             "different run configuration; remove it or use "
                             "a different path")
        names: dict[int, str] = {}
        skip, base0, resumed_written = cfg.skip_records, 0, 0
        if ckpt is not None:
            names = dict(ckpt.names)
            skip, base0 = ckpt.records_read, ckpt.base_idx
            resumed_written = ckpt.n_written
            observe.count("dump_records", resumed_written)
            log(f"Resuming from checkpoint: {skip} records already scanned, "
                f"{resumed_written} sequences already dumped")
        # a store's batches stream straight from mmap, and its delta base
        # replaces the query majority so uploads reuse the stored diffs
        streamer, pairs, delta_base = open_reference_stream(
            ref_paths, pack.n_sites, cfg.pool, majority_code(pack.codes),
            limit_records=cfg.limit_records,
            ref_ambiguity=cfg.ref_ambiguity,
            exclude_names=set(pack.names) if cfg.exclude_self else None,
            skip_records=skip, initial_base=base0)
        if ckpt is not None:
            streamer.stats.count = ckpt.records_read
            streamer.stats.n_invalid = ckpt.n_invalid
            streamer.stats.same_name = ckpt.same_name
        qd = scan.build_device_data(
            pack, k=cfg.nbest, device=dev,
            site_shards=cfg.site_shards if mesh is not None else 1,
            delta_base=delta_base)
        state = scan.init_state(pack.n_query, cfg.nbest, device=dev) \
            if ckpt is None else (_up(ckpt.state_scores, dev),
                                  _up(ckpt.state_idx, dev))

    with observe.span("dump_write"):
        dump_base = cfg.prefix + ".aln"
        dump_path = dump_base + WRITE_CODEC_SUFFIX[cfg.codec]
        if ckpt is not None:
            # drop any truncated stream a crash left after the snapshot
            if os.path.exists(dump_path) and \
                    os.path.getsize(dump_path) >= ckpt.dump_bytes:
                os.truncate(dump_path, ckpt.dump_bytes)
            else:
                raise SystemExit(
                    f"{dump_path} is smaller than the checkpoint recorded; "
                    "the dump and checkpoint no longer match")
        writer = make_fasta_writer(dump_base, cfg.codec,
                                   append=ckpt is not None)

    def dump(rows):
        """Write (global index, dump_entry) rows to the dump."""
        n = 0
        with observe.span("dump_write"):
            for g, entry in rows:
                names[g] = entry[0]
                write_dump(writer, entry)
                n += 1
            observe.count("dump_records", n)

    scan_t0 = root.seconds()
    with observe.span("device_data"):
        mode = (_Dense(qd, state, dump, dev, mesh) if not cfg.prune else
                _Prune(qd, state, dump, dev, pack, cfg.pool) if mesh is None
                else _ShardedPrune(qd, state, dump, dev, pack, mesh, cfg.pool))
    last_print, last_ckpt = 0, time.time()

    def _save_ckpt(prev_batch, state_host):
        """Snapshot through `prev_batch` (state_host: the state there),
        the dump closed first to end on a complete stream."""
        nonlocal writer, resumed_written, last_ckpt
        last_ckpt = time.time()
        with observe.span("checkpoint"):
            resumed_written += writer.n_written
            writer.close()
            ckpt_mod.save(cfg.checkpoint, ckpt_mod.ScanCheckpoint(
                version=ckpt_mod._VERSION,
                records_read=prev_batch.records_read,
                base_idx=prev_batch.base_idx + prev_batch.n,
                n_invalid=prev_batch.n_invalid,
                same_name=prev_batch.same_name,
                n_written=resumed_written,
                state_scores=state_host[0], state_idx=state_host[1],
                names=names, config_key=ckpt_key,
                dump_bytes=os.path.getsize(dump_path)))
            writer = make_fasta_writer(dump_base, cfg.codec, append=True)

    for batch, payload in observe.iter_spans("stream_wait", pairs):
        due = cfg.checkpoint is not None and \
            time.time() - last_ckpt >= cfg.checkpoint_every
        snap = mode.snapshot(batch) if due and mode.snapshot_first else None
        with observe.span("upload_prune"):
            flags = mode.step(batch, payload)
            count_upload(payload)
        mode.settle(batch, flags)
        if due and not mode.snapshot_first:
            snap = mode.snapshot(batch)
        if snap is not None:
            _save_ckpt(*snap)
        total = batch.base_idx + batch.n
        if total - last_print >= cfg.print_interval:
            last_print = total
            elapsed = root.seconds() - scan_t0
            rate = (total - base0) / max(elapsed, 1e-9)
            log(f"Total: {streamer.stats.count} sequences analysed, "
                f"{resumed_written + writer.n_written} saved, "
                f"{streamer.stats.n_invalid} "
                f"poorly resolved. {rate:,.0f} genomes/sec. "
                f"{elapsed:.1f}s elapsed.")
    mode.finish()
    for name, n in (("rows_read", streamer.stats.count),
                    ("rows_invalid", streamer.stats.n_invalid),
                    ("rows_same_name", streamer.stats.same_name)):
        observe.count(name, n)
    counts = root.counts
    total = counts["rows_read"] - counts["rows_invalid"] - \
        counts["rows_same_name"]
    if cfg.prune:
        n_skipped = total - counts.get("rows_scored", 0)
        log(f"Prefilter skipped the exact scan for {n_skipped} of "
            f"{total} references (losslessly)")
    else:
        observe.count("rows_scored", total)
    with observe.span("dump_close"):
        writer.close()
        observe.count("dump_bytes", os.path.getsize(dump_path))

    scores, indices = mode.host_state()
    result = NearestResult(
        pack=pack, scores=scores, indices=indices, names=names,
        n_scanned=streamer.stats.count,
        n_saved=resumed_written + writer.n_written,
        n_invalid=streamer.stats.n_invalid,
        same_name=streamer.stats.same_name,
    )
    log(f"Total of {counts['rows_read']} sequences read; "
        f"{counts.get('dump_records', 0)} saved (close or intermediate), "
        f"{counts['rows_invalid']} too ambiguous (excluded). "
        f"{root.seconds() - scan_t0:.2f}s scan time.")
    if cfg.exclude_self:
        log(f" {counts['rows_same_name']} reference sequences already "
            "present in query alignment (based on name only).")
    csv_path = cfg.prefix + ".csv" + WRITE_CODEC_SUFFIX[cfg.codec]
    with observe.span("csv"):
        result.write_csv(csv_path)
        log(f"Saved distance table to {csv_path} ; "
            f"{root.seconds():.2f}s total.")
    return result
