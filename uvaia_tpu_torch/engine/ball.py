"""Radius search (``uvaia ball``) on PyTorch — the counterpart of
``uvaia_tpu/engine/ball.py`` for one device.

Keeps references close to the query set, streaming the database in
device batches.  Mirrors src/ball.c:137-289 + the staged distance
decomposition of `seq_ball_against_query_structure`
(fastaseq.c:660-696).  With d_cons = d(ref, consensus | idx_c)
+ d(ref, consensus | idx_m) (stages 1+2) the reference's exact keep
rule — reproduced here bit-for-bit — is:

  keep  <=>  2 * d_cons <= distance
             OR  d_cons + min_q d(ref, q | idx) <= distance

The first disjunct is a quirk of the C: stage 3's loop guard
`(*min_dist + c_dist) >= ball_radius` (fastaseq.c:674,691) is evaluated
on entry with *min_dist == c_dist == d_cons, so whenever
2*d_cons <= distance the per-query polymorphic stage is skipped
entirely and the ref is kept regardless of per-query distances.  It is
reproduced for output parity.  Redundant query sequences are always
removed first (ball.c:190).

Documented deviation, as in the JAX package: the reference-quality
threshold follows the nearest convention, rejecting refs with fewer
than (1-ref_ambiguity)*L valid sites.

A batch arrives as a sparse delta (rebuilt on the device by
ops/scan.reconstruct_delta: on a CUDA device the hand-written kernel of
csrc/recon.cu) or as 4-bit packed codes; the distances are the exact
integer products of ops/distance.py.  The device is explicit
(``BallConfig.device``): a missing GPU is an error, never a silent CPU
run.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..io import store as store_mod
from ..io.fasta import make_fasta_writer
from ..ops import distance as dist_ops
from ..ops.host import majority_code
from ..ops.scan import reconstruct_delta, unpack_codes, upload
from ..ops.score_kernels import full_float32_matmuls
from .nearest import resolve_device
from .query import build_query_pack, log
from .stream import EncodedStream, RefStreamer, dump_entry, write_dump


@dataclass
class BallConfig:
    distance: int = 5
    trim: int = 0
    acgt: bool = False
    keep_resolved: bool = False
    query_ambiguity: float = 0.5
    ref_ambiguity: float = 0.5
    pool: int = 4096
    output: str | None = None
    print_interval: int = 50000
    codec: str = "xz"                # output compression: xz/bz2/gz/raw
    device: str = "cuda"             # "cuda" (kernels) or "cpu" (plain)

    @property
    def prefix(self) -> str:
        return self.output if self.output else "ball_uvaia"


# the distance products run as float32 matmuls, exact only in full
# float32 precision (ops/distance.exact_dot)
@full_float32_matmuls()
def run_ball(ref_paths: list[str], query_path: str, cfg: BallConfig):
    dev = resolve_device(cfg.device)
    t0 = time.time()
    cfg.query_ambiguity = min(max(cfg.query_ambiguity, 0.001), 1.0)
    cfg.ref_ambiguity = min(max(cfg.ref_ambiguity, 0.001), 1.0)
    pack = build_query_pack(query_path, trim=cfg.trim, acgt=cfg.acgt,
                            ambiguity=cfg.query_ambiguity,
                            keep_resolved=cfg.keep_resolved,
                            always_exclude_redundant=True)
    L = pack.n_sites
    # distance clamp as in fastaseq.c:713-714
    dist = max(0, min(cfg.distance, (L - 2 * pack.trim) // 10))
    log(f"Radius search: {pack.n_query} queries, radius {dist}")

    def up(x: np.ndarray) -> torch.Tensor:
        return upload(x, dev)

    cons_sites = np.concatenate([pack.idx_c, pack.idx_m]).astype(np.int32)
    cons_sites_d = up(cons_sites)
    cons_codes_d = up(pack.consensus[cons_sites])
    idx = pack.idx.astype(np.int32)
    idx_d = up(idx)
    weights = up(dist_ops.mismatch_weights(pack.codes[:, idx], cfg.acgt))

    n_store = sum(store_mod.is_store(p) for p in ref_paths)
    if n_store and n_store != len(ref_paths):
        raise SystemExit(
            "reference inputs mix ingested stores and FASTA files; "
            "scan them in separate runs (or ingest the FASTA too)")
    store_mode = n_store > 0
    delta_base = majority_code(pack.codes)
    if store_mode:
        # stored diff lists are against the store's own base
        sb = store_mod.peek_store_base(ref_paths[0])
        if sb is not None:
            delta_base = sb
    delta_base_d = up(delta_base)

    def keep_rule(ref_codes, ok):
        d_cons = dist_ops.cons_mismatches(ref_codes, cons_sites_d,
                                          cons_codes_d, cfg.acgt)
        d_q = dist_ops.pair_mismatches(
            ref_codes.index_select(1, idx_d.long()), weights)
        mindist = d_cons + d_q.min(dim=1).values
        # C keep rule incl. the skipped-stage-3 quirk (see module docstring)
        keep = (2 * d_cons <= dist) | (mindist <= dist)
        return ok & keep, mindist

    streamer_cls = store_mod.StoreStreamer if store_mode else RefStreamer
    streamer = streamer_cls(ref_paths, L, cfg.pool,
                            ref_ambiguity=cfg.ref_ambiguity)
    # the kept set can be a large DB fraction (radius searches on
    # surveillance data keep whole lineages); multi-stream xz on a
    # thread pool keeps the writer off the streaming critical path
    writer = make_fasta_writer(cfg.prefix + ".aln", cfg.codec)
    t1 = time.time()
    last_print = 0
    pending = None
    steps = {"delta": 0, "packed": 0}

    def drain(pending):
        keep, batch = pending
        keep = keep.cpu().numpy()[: batch.n]
        for i in np.nonzero(keep)[0]:
            write_dump(writer, dump_entry(batch, int(i)))

    pairs = streamer if store_mode else EncodedStream(streamer, delta_base)
    try:
        for batch, payload in pairs:
            if payload[0] == "delta":  # sparse-delta upload (see ops/host)
                codes = reconstruct_delta(delta_base_d, up(payload[1]),
                                          up(payload[2]))
                steps["delta"] += 1
            else:
                codes = unpack_codes(up(payload[1]), L)
                steps["packed"] += 1
            keep, _ = keep_rule(codes, up(batch.ok))
            # drained one batch late: the host writes batch k while the
            # device scores batch k + 1
            if pending is not None:
                drain(pending)
            pending = (keep, batch)
            if streamer.stats.count - last_print >= cfg.print_interval:
                last_print = streamer.stats.count
                log(f"{streamer.stats.count} sequences analysed in total, "
                    f"{writer.n_written} saved, {streamer.stats.n_invalid} "
                    f"rejected due to high ambiguity; "
                    f"{time.time()-t1:.3f} secs passed")
        if pending is not None:
            drain(pending)
    finally:
        # a mid-stream error (e.g. length-mismatch SystemExit) must
        # still flush buffered + in-flight compressed chunks
        writer.close()
    log(f"Total of {streamer.stats.count} sequences read, "
        f"{writer.n_written} within radius (kept), "
        f"{streamer.stats.n_invalid} too ambiguous (excluded). "
        f"{time.time()-t0:.3f} secs.")
    return dict(count=streamer.stats.count, kept=writer.n_written,
                invalid=streamer.stats.n_invalid, steps=steps)
