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

import numpy as np
import torch

from ..io import store as store_mod
from ..io.compress import open_write
from ..io.fasta import WRITE_CODEC_SUFFIX, make_fasta_writer
from ..ops import scan
from ..ops.host import IDX_SENTINEL
from ..ops.score_kernels import full_float32_matmuls
from ..parallel import mesh as pmesh
from ..utils import checkpoint as ckpt_mod
from ..utils.observe import Chronometer, maybe_profile
from .query import QueryPack, build_query_pack, log
from .stream import EncodedStream, RefStreamer, dump_entry, write_dump

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
        with open_write(path) as fh:
            fh.write((CSV_HEADER_ACGT if self.pack.acgt
                      else CSV_HEADER_FULL).encode())
            for row in self.rows():
                q, r, rank, *s = row
                fh.write((f"{q},{r},{rank}," +
                          ",".join(map(str, s)) + "\n").encode())


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


def run_nearest(ref_paths: list[str], query_path: str,
                cfg: NearestConfig) -> NearestResult:
    with maybe_profile():
        return _run_nearest(ref_paths, query_path, cfg)


# prune_step's site product runs as a float32 matmul, exact only in
# full float32 precision (score_kernels.exact_counts)
@full_float32_matmuls()
def _run_nearest(ref_paths: list[str], query_path: str,
                 cfg: NearestConfig) -> NearestResult:
    dev = resolve_device(cfg.device)
    cfg.clamp()
    mesh = make_run_mesh(cfg, dev)
    if mesh is not None:
        n_db = mesh.shape["db"]
        cfg.pool = -(-cfg.pool // n_db) * n_db   # round up to divide evenly
        dev = mesh.lead
    chrono = Chronometer()
    t0 = time.time()
    pack = build_query_pack(query_path, trim=cfg.trim, acgt=cfg.acgt,
                            ambiguity=cfg.query_ambiguity,
                            keep_resolved=cfg.keep_resolved)
    log(f"Prepared {pack.n_query} query sequences in "
        f"{time.time()-t0:.2f}s; scanning with top-k={cfg.nbest}, "
        f"batch={cfg.pool}")
    if cfg.acgt:
        log("Considering ACGT differences only "
            "(excluding all other characters).")
    else:
        log("Considering text match and partially ambiguous "
            "(excluding only gaps and Ns).")

    def up(x: np.ndarray) -> torch.Tensor:
        return scan.upload(x, dev)

    # persistent-store inputs (io/store.py): batches stream
    # straight from mmap; the store's delta base replaces the query
    # majority so uploads reuse the stored diff lists
    n_store = sum(store_mod.is_store(p) for p in ref_paths)
    if n_store and n_store != len(ref_paths):
        raise SystemExit(
            "reference inputs mix ingested stores and FASTA files; "
            "scan them in separate runs (or ingest the FASTA too)")
    store_mode = n_store > 0
    store_base = store_mod.peek_store_base(ref_paths[0]) if store_mode \
        else None

    qd = scan.build_device_data(
        pack, k=cfg.nbest, device=dev,
        site_shards=cfg.site_shards if mesh is not None else 1)
    if mesh is not None:
        log(f"Sharded scan over mesh (db={n_db}, site={cfg.site_shards})")
    if store_base is not None:
        qd.delta_base = up(store_base)
    delta_base = qd.delta_base.cpu().numpy()
    state = scan.init_state(pack.n_query, cfg.nbest, device=dev)

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
        state = (up(ckpt.state_scores), up(ckpt.state_idx))
        names = dict(ckpt.names)
        skip, base0 = ckpt.records_read, ckpt.base_idx
        resumed_written = ckpt.n_written
        log(f"Resuming from checkpoint: {skip} records already scanned, "
            f"{resumed_written} sequences already dumped")

    exclude = set(pack.names) if cfg.exclude_self else None
    streamer_cls = store_mod.StoreStreamer if store_mode else RefStreamer
    extra_kw = {}
    if cfg.limit_records:
        if not store_mode:
            raise SystemExit(
                "record-window scanning (limit_records) requires "
                "ingested store inputs")
        extra_kw["limit_records"] = cfg.limit_records
    streamer = streamer_cls(ref_paths, pack.n_sites, cfg.pool,
                            ref_ambiguity=cfg.ref_ambiguity,
                            exclude_names=exclude,
                            skip_records=skip, initial_base=base0,
                            **extra_kw)
    if ckpt is not None:
        streamer.stats.count = ckpt.records_read
        streamer.stats.n_invalid = ckpt.n_invalid
        streamer.stats.same_name = ckpt.same_name

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
    t1 = time.time()
    last_print = 0
    last_ckpt = time.time()

    def host_state(st):
        return (st[0].cpu().numpy(), st[1].cpu().numpy())

    def _save_ckpt(prev_batch, state_host):
        """Snapshot through `prev_batch` (drained; state_host is the
        merged state at exactly that point).  The dump writer is closed
        first so the file ends on a complete stream whose size the
        checkpoint records."""
        nonlocal writer, resumed_written
        resumed_written += writer.n_written
        writer.close()
        ckpt_mod.save(cfg.checkpoint, ckpt_mod.ScanCheckpoint(
            version=ckpt_mod._VERSION, records_read=prev_batch.records_read,
            base_idx=prev_batch.base_idx + prev_batch.n,
            n_invalid=prev_batch.n_invalid,
            same_name=prev_batch.same_name,
            n_written=resumed_written,
            state_scores=state_host[0], state_idx=state_host[1],
            names=names, config_key=ckpt_key,
            dump_bytes=os.path.getsize(dump_path)))
        writer = make_fasta_writer(dump_base, cfg.codec, append=True)

    def _drain(pending):
        flags, batch = pending
        flags = flags.cpu().numpy()[: batch.n]
        for i in np.nonzero(flags)[0]:
            names[batch.base_idx + int(i)] = batch.names[i]
            write_dump(writer, dump_entry(batch, int(i)))

    pairs = streamer if store_mode else EncodedStream(streamer, delta_base)

    def ridx_of(batch, payload) -> torch.Tensor:
        return up(batch.base_idx + np.arange(payload[1].shape[0],
                                             dtype=np.int32))

    def make_step_fn():
        if mesh is None:
            def step_fn(st, batch, payload):
                ok = up(batch.ok)
                if payload[0] == "delta":
                    return scan.scan_step_delta(
                        qd, st, up(payload[1]), up(payload[2]), ok,
                        batch.base_idx)
                return scan.scan_step_packed(qd, st, up(payload[1]), ok,
                                             batch.base_idx)
            return step_fn
        # dense sharded steps: only the --no-prune loop uses these (the
        # sharded prune path builds its own survivor ops)
        sh_step = pmesh.make_sharded_scan_step(qd, mesh)
        sh_step_delta = pmesh.make_sharded_scan_step(qd, mesh, delta=True)

        def step_fn(st, batch, payload):
            ok, ridx = up(batch.ok), ridx_of(batch, payload)
            if payload[0] == "delta":
                return sh_step_delta(st, up(payload[1]), up(payload[2]), ok,
                                     ridx)
            return sh_step(st, up(payload[1]), ok, ridx)
        return step_fn

    def _progress(total):
        nonlocal last_print
        if total - last_print >= cfg.print_interval:
            last_print = total
            rate = (total - base0) / max(time.time() - t1, 1e-9)
            log(f"Total: {streamer.stats.count} sequences analysed, "
                f"{resumed_written + writer.n_written} saved, "
                f"{streamer.stats.n_invalid} "
                f"poorly resolved. {rate:,.0f} genomes/sec. "
                f"{time.time()-t1:.1f}s elapsed.")

    if cfg.prune and mesh is not None:
        # ---- sharded two-phase with device-resident survivor buffers:
        # prune data-parallel over 'db'; each shard compacts its own
        # surviving rows into its own buffer (no re-upload); a flush
        # scores every shard's buffer and merges the candidates
        scan.build_prune_data(qd, pack)
        B_loc = cfg.pool // n_db
        cap_loc = 2 * B_loc
        sv_init, prune_acc, prune_acc_delta, sv_flush = \
            pmesh.make_sharded_survivor_ops(qd, mesh, cap_loc)
        bufs = sv_init()
        retained: dict[int, tuple] = {}
        n_surv = 0

        def flush_p2_sharded():
            nonlocal state, retained
            if not retained:
                return
            idxs = bufs.indices()
            state, flags, _ = sv_flush(state, bufs)
            for slot in np.nonzero(flags.cpu().numpy())[0]:
                g = int(idxs[slot])
                entry = retained[g]
                names[g] = entry[0]
                write_dump(writer, entry)
            retained = {}

        for batch, payload in pairs:
            ok, ridx = up(batch.ok), ridx_of(batch, payload)
            if payload[0] == "delta":
                survive, bufs = prune_acc_delta(
                    state, bufs, up(payload[1]), up(payload[2]), ok, ridx)
            else:
                survive, bufs = prune_acc(state, bufs, up(payload[1]), ok,
                                          ridx)
            sv = np.nonzero(survive.cpu().numpy()[: batch.n])[0]
            for i in sv:
                retained[batch.base_idx + int(i)] = dump_entry(batch, int(i))
            n_surv += len(sv)
            # rows past a shard's buffer end would be lost: flush
            # whenever the fullest shard could overflow on the next batch
            if int(bufs.fill().max()) + B_loc > cap_loc:
                flush_p2_sharded()
            if cfg.checkpoint is not None and \
                    time.time() - last_ckpt >= cfg.checkpoint_every:
                flush_p2_sharded()
                last_ckpt = time.time()
                _save_ckpt(batch, host_state(state))
            _progress(batch.base_idx + batch.n)
        flush_p2_sharded()
        total = streamer.stats.count - streamer.stats.n_invalid - \
            streamer.stats.same_name
        log(f"Prefilter skipped the exact scan for {total - n_surv} of "
            f"{total} references (losslessly)")
    elif cfg.prune:
        scan.build_prune_data(qd, pack)
        # ---- two-phase: phase 1 prunes on the device; surviving rows
        # are compacted into a device buffer (no re-upload) and phase 2
        # scores the buffer when it could overflow.  Capacity: ~1 GB of
        # device memory, and at least two batches.
        W = qd.width
        cap = max(2 * cfg.pool, min(8 * cfg.pool, (1 << 30) // max(W, 1)))
        buf, buf_idx, buf_n = scan.new_survivor_buffer(cap, W, dev)
        # host copies of only the SURVIVOR rows (name + dump payload),
        # keyed by global index
        retained: dict[int, tuple] = {}
        n_surv = 0
        warmed_up = False
        n_buf_host = 0    # lagged host mirror of buf_n (see drain)
        pending = None    # (survive_dev, batch), drained ONE BEHIND

        def drain_pending():
            nonlocal pending, n_surv, n_buf_host
            if pending is None:
                return
            survive_d, pbatch = pending
            pending = None
            sv = np.nonzero(survive_d.cpu().numpy()[: pbatch.n])[0]
            for i in sv:
                retained[pbatch.base_idx + int(i)] = \
                    dump_entry(pbatch, int(i))
            n_surv += len(sv)
            n_buf_host += len(sv)

        def flush_p2():
            nonlocal state, retained, n_buf_host
            drain_pending()
            if n_buf_host == 0:
                retained = {}
                return
            state, flags = scan.flush_survivors(qd, state, buf, buf_idx,
                                                buf_n)
            flags = flags.cpu().numpy()
            idxs = buf_idx.cpu().numpy()
            for slot in np.nonzero(flags)[0]:
                g = int(idxs[slot])
                entry = retained[g]
                names[g] = entry[0]
                write_dump(writer, entry)
            retained = {}
            buf_n.zero_()
            n_buf_host = 0

        for batch, payload in pairs:
            ok = up(batch.ok)
            if payload[0] == "delta":
                survive, codes_d = scan.prune_and_hold_delta(
                    qd, state, up(payload[1]), up(payload[2]), ok)
            else:
                survive, codes_d = scan.prune_and_hold(
                    qd, state, up(payload[1]), ok)
            scan.accumulate_survivors(buf, buf_idx, buf_n, codes_d,
                                      survive, batch.base_idx)
            drain_pending()               # sync batch i-1, not i
            pending = (survive, batch)
            # after the drain n_buf_host covers through batch i-1 and the
            # buffer through batch i: if n_buf_host + 2*pool <= cap, a
            # fully surviving batch i plus the NEXT batch still fit.  The
            # warm-up flush fires on the first batch: thresholds tighten
            # only at flushes, and an empty state prunes nothing
            if not warmed_up or n_buf_host + 2 * cfg.pool > cap:
                flush_p2()
                warmed_up = True
            if cfg.checkpoint is not None and \
                    time.time() - last_ckpt >= cfg.checkpoint_every:
                flush_p2()
                last_ckpt = time.time()
                _save_ckpt(batch, host_state(state))
            _progress(batch.base_idx + batch.n)
        flush_p2()
        total = streamer.stats.count - streamer.stats.n_invalid - \
            streamer.stats.same_name
        log(f"Prefilter skipped the exact scan for {total - n_surv} of "
            f"{total} references (losslessly)")
    else:
        step_fn = make_step_fn()
        pending = None  # (flags_device, batch) for one-batch pipelining
        for batch, payload in pairs:
            # a due checkpoint snapshots the state BEFORE this step,
            # consistent with the dump/stream position after draining
            # the previous batch
            ckpt_due = (cfg.checkpoint is not None and pending is not None
                        and time.time() - last_ckpt >= cfg.checkpoint_every)
            if ckpt_due:
                state_host = host_state(state)
            state, flags_d = step_fn(state, batch, payload)
            if pending is not None:
                prev = pending[1]
                _drain(pending)
                if ckpt_due:
                    last_ckpt = time.time()
                    _save_ckpt(prev, state_host)
            pending = (flags_d, batch)
            _progress(batch.base_idx + batch.n)
        if pending is not None:
            _drain(pending)
    writer.close()

    scores, indices = host_state(state)
    result = NearestResult(
        pack=pack, scores=scores, indices=indices, names=names,
        n_scanned=streamer.stats.count,
        n_saved=resumed_written + writer.n_written,
        n_invalid=streamer.stats.n_invalid,
        same_name=streamer.stats.same_name,
    )
    log(f"Total of {result.n_scanned} sequences read; {result.n_saved} "
        f"saved (close or intermediate), {result.n_invalid} too ambiguous "
        f"(excluded). {time.time()-t1:.2f}s scan time.")
    if cfg.exclude_self:
        log(f" {result.same_name} reference sequences already present in "
            "query alignment (based on name only).")
    csv_path = cfg.prefix + ".csv" + WRITE_CODEC_SUFFIX[cfg.codec]
    result.write_csv(csv_path)
    log(f"Saved distance table to {csv_path} ; "
        f"{chrono.total():.2f}s total.")
    return result
