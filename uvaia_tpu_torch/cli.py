"""Command line of the PyTorch port: ``python -m uvaia_tpu_torch
nearest|align|ball|cluster|legacy|ingest|info``.

The flags are uvaia_tpu's own (the port's copies of the subcommand
parsers of ``uvaia_tpu/cli/main.py``), plus ``--device {cuda,cpu}`` on
the five tools; ``nearest`` runs in full mode and with ``--acgt``, on
one device, sharded over several (``--devices``, ``--site-shards``), or
in several processes that merge their results (``--num-hosts``,
``--host-id``, ``--coordinator``).  ``ingest`` writes the same store directory as
``uvaia_tpu ingest``, and ``info`` reads either package's stores.
Exit codes are uvaia_tpu's: 2 for a file that cannot be opened or
written, 1 for ``info --verify`` on a corrupt store, 130 on interrupt,
and a quiet 0 when a reader closes the output pipe.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__

_SCORE_EPILOG = """\
scoring / ranking semantics (reference: nearest.c:130-152, README.md:254-330):

Neighbours are ranked by MATCH counts (similarity), not distances, with
each later column breaking ties in the previous one:
  1. ACGT_matches            matches counting only unambiguous A/C/G/T
  2. text_matches            exact character matches (M-M counts, M-A
                             does not)
  3. partial_matches         IUPAC-aware: M-A counts because M={A,C};
                             the fully ambiguous N never counts
  4. valid_pair_comparisons  the effective compared length: sites where
                             NEITHER sequence has a gap or N
  5. ACGT_matches_unique     matches at sites where the query differs
                             from the query-set consensus (prefers
                             neighbours far from the queries' common
                             ancestor on ties)
  6. valid_ref_sites         non-gap/non-N sites in the reference
                             (prefers better-resolved references last)

Columns 1, 3 and 4 are the most useful; `valid_pair_comparisons -
partial_matches` approximates an snp-dists-style SNP distance (sites
with a gap/N in either sequence are ignored; partially ambiguous codes
still count, so K vs A is a real mismatch here that snp-dists drops).
Matches are tracked instead of mismatches because poorly-resolved
sequences trivially have few mismatches: as a scan progresses the
"highest ACGT mismatches in neighbourhood" can legitimately RISE while
better-resolved (more informative) neighbours replace low-quality ones.

Poorly-resolved queries (many Ns/indels) have more equally-near
neighbours since only non-N sites are compared.  --keep_resolved drops
a query when another query is a strictly more resolved version of it
(no conflicting SNPs, e.g. AA--CG-C is redundant given AAAGCG-C, but
AAA-CGAC and AAA-CGTC each carry information of their own and are
kept).

--acgt emulates ACGT-only tools (still match-counting): the table then
carries dist_consensus and dist_unique columns whose sum is the usual
SNP distance.

Absolute match counts depend on how the query set is compressed and
indexed and may differ between implementations or runs; the ranks (and
distances) are what is preserved.

The output alignment <prefix>.aln.xz accumulates every reference that
was EVER in some query's current best set (a superset of the final
k-NN, appended during the scan so an interrupted run keeps a useful
file); the ranked CSV <prefix>.csv.xz holds the final per-query
neighbours."""


def _add_nearest(sub):
    p = sub.add_parser(
        "nearest", help="for every query sequence, find closest "
        "neighbours in a (huge, streamed) aligned reference database",
        epilog=_SCORE_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--acgt", action="store_true",
                   help="consider only ACGT sites (unambiguous SNPs)")
    p.add_argument("-k", "--keep_resolved", action="store_true",
                   help="keep more resolved, exclude redundant queries")
    p.add_argument("-x", "--exclude_self", action="store_true",
                   help="exclude references with same name as a query")
    p.add_argument("-n", "--nbest", type=int, default=100,
                   help="number of best references per query (default 100)")
    p.add_argument("--trim", type=int, default=0,
                   help="sites to trim from both ends (sarscov2: 230)")
    p.add_argument("-a", "--query_ambiguity", type=float, default=0.5)
    p.add_argument("-A", "--ref_ambiguity", type=float, default=0.5)
    p.add_argument("-p", "--pool", type=int, default=4096,
                   help="references scored per device batch")
    p.add_argument("-r", "--reference", action="append", required=True,
                   help="aligned reference database (repeatable)")
    p.add_argument("fasta", help="aligned query sequences")
    p.add_argument("-t", "--nthreads", type=int, default=None,
                   help="accepted for compatibility (device-parallel here)")
    p.add_argument("-o", "--output", default=None,
                   help="prefix of output alignment and csv")
    p.add_argument("--devices", type=int, default=None,
                   help="shard the scan over this many devices of the "
                        "--device type, driven by this one process (cuda: "
                        "cuda:0 .. cuda:N-1; cpu: N shards on the CPU); "
                        "each scores its share of every batch, and the "
                        "top-k candidates are merged on the first")
    p.add_argument("--site-shards", type=int, default=1,
                   help="additionally split the alignment sites over this "
                        "many of the devices (devices = db x site); the "
                        "partial counts are summed")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-process scan: total number of processes, "
                        "started once each with its --host-id (each scans "
                        "a contiguous file range, or row range of ingested "
                        "stores; the top-k states are gathered over a "
                        "torch.distributed gloo group at the end and "
                        "process 0 writes the CSV)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this process's id in [0, num-hosts)")
    p.add_argument("--coordinator", default=None,
                   help="host:port where process 0 listens for the gloo "
                        "group's rendezvous (same value in every process; "
                        "required with --num-hosts > 1)")
    p.add_argument("--checkpoint", default=None,
                   help="path for periodic scan checkpoints (resume-able)")
    p.add_argument("--checkpoint_every", type=float, default=60.0,
                   help="seconds between checkpoint snapshots")
    p.add_argument("--no-prune", action="store_true",
                   help="disable the (lossless) two-phase prefilter")
    _add_codec(p)
    return p


def _add_codec(p):
    p.add_argument("--codec", default="xz",
                   choices=["xz", "bz2", "gz", "raw"],
                   help="output compression (the reference's writer "
                        "ladder xz>bz2>gz>raw, nearest.c:234-236; "
                        "xz default)")


def _add_align(sub):
    p = sub.add_parser(
        "align", help="align query sequences against a reference",
        epilog="Global affine-gap alignment with the reference's "
               "penalties {match 0, mismatch 4, gap open 6, gap "
               "extend 2} (align.c:306, 'bwa-mem values').  Each "
               "output row is projected onto reference coordinates: "
               "insertions relative to the reference are DROPPED, "
               "deletions become '-', so every row has exactly the "
               "reference length (align.c:366-390).  Queries outside "
               "[2/3, 3/2] of the reference length or failing the "
               "ambiguity thresholds are skipped (align.c:190-202).  "
               "Unlike WFA-Adapt, emitted rows carry an optimality "
               "certificate: rows whose optimum escapes the banded "
               "search are re-aligned at a provably sufficient band.",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stdout", action="store_true",
                   help="print alignment to stdout instead of xz file")
    p.add_argument("-a", "--ambiguity", type=float, default=0.5)
    p.add_argument("-p", "--pool", type=int, default=1024,
                   help="query sequences aligned per device batch "
                        "(1024 measured fastest on 30kb genomes)")
    p.add_argument("--band", type=int, default=1024,
                   help="DP band width (auto-widened on demand)")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("fasta", nargs="+")
    p.add_argument("-t", "--nthreads", type=int, default=None)
    p.add_argument("-o", "--output", default=None)
    _add_codec(p)
    return p


def _add_ball(sub):
    p = sub.add_parser(
        "ball", help="keep references within a distance "
        "radius of any query sequence",
        epilog="Keeps every reference whose ACGT mismatch distance to "
               "at least ONE query is <= --distance (ball.c:63: "
               "default 5).  Distances use a staged consensus "
               "decomposition (constant sites vs consensus first, "
               "then gapped-constant, then per-query polymorphic — "
               "fastaseq.c:660-696); redundant queries are always "
               "removed first (ball.c:190).  Output is an xz "
               "alignment of the kept references.",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-x", "--acgt", action="store_true")
    p.add_argument("-k", "--keep_resolved", action="store_true")
    p.add_argument("-d", "--distance", type=int, default=5)
    p.add_argument("--trim", type=int, default=0)
    p.add_argument("-a", "--query_ambiguity", type=float, default=0.5)
    p.add_argument("-A", "--ref_ambiguity", type=float, default=0.5)
    p.add_argument("-p", "--pool", type=int, default=4096)
    p.add_argument("-r", "--reference", action="append", required=True)
    p.add_argument("fasta")
    p.add_argument("-o", "--output", default=None)
    _add_codec(p)
    return p


def _add_cluster(sub):
    p = sub.add_parser(
        "cluster", help="one-pass canopy clustering/dedup",
        epilog="Canopy clustering: sequences within --distance ACGT "
               "mismatches of an existing medoid join its cluster, "
               "others found a new one; partial clusters are merged "
               "at the end (cluster.c:219-230).  Each cluster's "
               "medoid is its most-resolved member (furthest from the "
               "consensus reference on ties).  Outputs the medoid "
               "alignment and a membership CSV; partial tables are "
               "saved every --save-interval seconds for crash "
               "resilience (cluster.c:197-200).",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-d", "--distance", type=int, default=1)
    p.add_argument("--trim", type=int, default=0)
    p.add_argument("-p", "--pool", type=int, default=1024,
                   help="sequences clustered per device batch")
    p.add_argument("-s", "--snps", type=int, default=1)
    p.add_argument("-r", "--reference", default=None)
    p.add_argument("--save-interval", type=float, default=30.0,
                   help="seconds between partial membership saves "
                        "(crash resilience, as in uvaiaclust)")
    p.add_argument("fasta", nargs="+")
    p.add_argument("-o", "--output", default=None)
    _add_codec(p)
    return p


def _add_ingest(sub):
    p = sub.add_parser(
        "ingest", help="index an aligned reference database once into a "
        "persistent binary store; nearest/ball/cluster/legacy then scan "
        "it with zero decompression (pass the store directory wherever "
        "a reference FASTA is accepted)")
    p.add_argument("-o", "--output", required=True,
                   help="store directory to create (must not exist)")
    p.add_argument("--block", type=int, default=4096,
                   help="rows per store block (default 4096, matching "
                        "the default scan pool)")
    p.add_argument("--frames", action="store_true",
                   help="also pre-compress every row as an xz dump "
                        "frame (scan-time dumps become byte copies; "
                        "costs one xz stream a row at ingest — worth it "
                        "only when the store is dump-scanned many times)")
    p.add_argument("--append", action="store_true",
                   help="extend an EXISTING store in place (new "
                        "sequence drops without a full re-ingest; the "
                        "frames setting is inherited from the store)")
    p.add_argument("fasta", nargs="+",
                   help="aligned reference database(s), xz/gz/bz2/raw")
    return p


def _add_info(sub):
    p = sub.add_parser(
        "info", help="inspect an ingested store: rows, sites, block "
        "mix, dump frames, per-component bytes, valid-site spread")
    p.add_argument("store", help="store directory written by `ingest`")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--verify", action="store_true",
                   help="recompute every block's ingest-time CRC32 and "
                        "check section extents; exit 1 on corruption")
    return p


def _add_legacy(sub):
    p = sub.add_parser(
        "legacy", help="in-memory searcher (pre-2022 uvaia behaviour)",
        epilog="Loads the WHOLE reference DB + queries in memory and "
               "prints, per query, a table of the best references "
               "(valid_sites, ACGT_matches, prop_char_matches, "
               "partial_matches) selected in three stages: by ACGT "
               "matches, then by char-match proportion among the top "
               "n/8, then by IUPAC-weighted partial matches among the "
               "top n/16 (utils.c:87-161).  Partial matches weight "
               "T vs W as 0.5 (utils.c:73); see --partial-rule for "
               "the ambiguity-vs-ambiguity entries.  Use `nearest` "
               "for databases too large for memory.",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-n", "--nbest", type=int, default=8)
    p.add_argument("-m", "--nmax", type=int, default=0,
                   help="max best refs when several optimal (default "
                   "2 x nbest)")
    p.add_argument("--trim", type=int, default=0)
    p.add_argument("-a", "--query_ambiguity", type=float, default=0.5)
    p.add_argument("-A", "--ref_ambiguity", type=float, default=0.5)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("fasta")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-t", "--nthreads", type=int, default=None,
                   help="accepted for compatibility (uvaia.c:43; "
                   "device-parallel here)")
    p.add_argument("--partial-rule", default="product",
                   choices=["product", "jaccard", "max"],
                   help="ambiguity-vs-ambiguity entries of the "
                        "weighted-partial table (biomcmc-lib's exact "
                        "table is unrecoverable; all candidates agree "
                        "on the documented pins incl. T vs W = 0.5 — "
                        "on the bundled data the choice moves only "
                        "63/1000 queries' stage-3 extras)")
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="uvaia_tpu_torch",
        description="uvaia search and alignment on PyTorch + CUDA")
    ap.add_argument("-v", "--version", action="version",
                    version=f"uvaia_tpu_torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for add in (_add_nearest, _add_align, _add_ball, _add_cluster,
                _add_legacy):
        add(sub).add_argument(
            "--device", default="cuda", choices=["cuda", "cpu"],
            help="cuda (default): the hand-written kernels and torch "
                 "ops on the GPU; cpu: the plain PyTorch versions")
    _add_ingest(sub)
    _add_info(sub)
    return ap


def main(argv=None) -> int:
    try:
        return _dispatch(build_parser().parse_args(argv))
    except FileNotFoundError as e:
        print(f"uvaia_tpu_torch: cannot open {e.filename}: {e.strerror}",
              file=sys.stderr)
        return 2
    except PermissionError as e:
        print(f"uvaia_tpu_torch: permission denied: {e.filename}",
              file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        print("uvaia_tpu_torch: interrupted", file=sys.stderr)
        return 130
    except BrokenPipeError:
        # `... --stdout | head`: the reader closed the pipe; exit quietly
        # (pointing stdout at devnull stops the interpreter re-raising
        # on its own flush at shutdown)
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 0


def _dispatch(args) -> int:
    if args.cmd == "align":
        from .engine.align import AlignConfig, run_align
        run_align(args.reference, args.fasta, AlignConfig(
            ambiguity=args.ambiguity, pool=args.pool, band=args.band,
            to_stdout=args.stdout, output=args.output, codec=args.codec,
            device=args.device))
        return 0
    if args.cmd == "ball":
        from .engine.ball import BallConfig, run_ball
        run_ball(args.reference, args.fasta, BallConfig(
            distance=args.distance, trim=args.trim, acgt=args.acgt,
            keep_resolved=args.keep_resolved,
            query_ambiguity=args.query_ambiguity,
            ref_ambiguity=args.ref_ambiguity, pool=args.pool,
            output=args.output, codec=args.codec, device=args.device))
        return 0
    if args.cmd == "cluster":
        from .engine.cluster import ClusterConfig, run_cluster
        cfg = ClusterConfig(distance=args.distance, trim=args.trim,
                            pool=args.pool, snps=args.snps,
                            reference=args.reference, output=args.output,
                            save_interval=args.save_interval,
                            codec=args.codec, device=args.device)
        run_cluster(args.fasta, cfg)
        return 0
    if args.cmd == "ingest":
        from .io.store import ingest

        def _progress(n, dt, _last=[0.0]):
            if dt - _last[0] >= 10.0:
                _last[0] = dt
                print(f"ingested {n} sequences, {n/max(dt,1e-9):,.0f} "
                      f"genomes/sec", file=sys.stderr)
        st = ingest(args.fasta, args.output, block=args.block,
                    progress=_progress, frames=args.frames,
                    append=args.append)
        verb = "Appended" if args.append else "Ingested"
        print(f"{verb} {st.n_rows} sequences x {st.n_sites} sites into "
              f"{args.output} ({st.bytes/1e6:.1f} MB, "
              f"{st.n_delta_blocks} delta + {st.n_packed_blocks} "
              f"packed-only blocks) in {st.seconds:.1f}s "
              f"({st.n_rows/max(st.seconds,1e-9):,.0f} genomes/sec)",
              file=sys.stderr)
        return 0
    if args.cmd == "info":
        import json as _json

        from .io.store import info, verify
        try:
            rec = info(args.store)
            if args.verify:
                rec["verify"] = verify(args.store)
        except ValueError as e:
            raise SystemExit(f"error: {e}")
        ver = rec.get("verify")
        if args.json:
            print(_json.dumps(rec, indent=1))
            return 0 if ver is None or ver["ok"] else 1
        vs = rec.get("valid_sites", {})
        print(f"{args.store}: {rec['format']} v{rec['version']}")
        print(f"  rows x sites     {rec['n_rows']} x {rec['n_sites']}")
        print(f"  blocks           {rec['n_blocks']} x {rec['block']} "
              f"rows ({rec['n_delta_blocks']} delta, "
              f"{rec['n_packed_only_blocks']} packed-only)")
        print(f"  dump frames      "
              f"{'yes' if rec['has_rowxz'] else 'no'}")
        print(f"  crc coverage     {rec['crc_blocks']}/{rec['n_blocks']}"
              f" blocks")
        if vs:
            print(f"  valid sites/row  min {vs['min']}  mean "
                  f"{vs['mean']}  max {vs['max']}")
        print(f"  total bytes      {rec['total_bytes']:,} "
              f"({rec['total_bytes']/max(rec['n_rows'],1):,.0f}/row)")
        for name, sz in rec["component_bytes"].items():
            print(f"    {name:<22} {sz:,}")
        print(f"  sources          {', '.join(rec['sources'])}")
        if ver is not None:
            state = "OK" if ver["ok"] else "CORRUPT"
            print(f"  verify           {state}: {ver['checked']} blocks "
                  f"checked, {ver['unknown']} pre-checksum", end="")
            if ver["bad_blocks"]:
                print(f", BAD blocks {ver['bad_blocks']}", end="")
            for e in ver["errors"]:
                print(f"\n    ERROR {e}", end="")
            print()
            return 0 if ver["ok"] else 1
        return 0
    if args.cmd == "legacy":
        from .engine.legacy import LegacyConfig, run_legacy
        run_legacy(args.reference, args.fasta, LegacyConfig(
            nbest=args.nbest, nmax=args.nmax, trim=args.trim,
            ambiguity=args.query_ambiguity,
            ref_ambiguity=args.ref_ambiguity, output=args.output,
            partial_rule=args.partial_rule, device=args.device))
        return 0
    from .engine.nearest import NearestConfig, run_nearest
    cfg = NearestConfig(
        nbest=args.nbest, trim=args.trim, acgt=args.acgt,
        keep_resolved=args.keep_resolved, exclude_self=args.exclude_self,
        query_ambiguity=args.query_ambiguity,
        ref_ambiguity=args.ref_ambiguity, pool=args.pool,
        output=args.output, n_devices=args.devices,
        site_shards=args.site_shards, checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every, prune=not args.no_prune,
        codec=args.codec, device=args.device)
    if args.num_hosts > 1:
        from .parallel.multihost import run_nearest_multihost
        run_nearest_multihost(args.reference, args.fasta, cfg,
                              args.num_hosts, args.host_id,
                              coordinator=args.coordinator)
    else:
        run_nearest(args.reference, args.fasta, cfg)
    return 0
