"""Command line of the PyTorch port: ``python -m uvaia_tpu_torch nearest``.

The ``nearest`` flags are uvaia_tpu's own (``uvaia_tpu.cli.main``'s
argparse builders), plus ``--device {cuda,cpu}``.  Options whose paths
are not ported yet (``--acgt``, ``--devices > 1``, ``--site-shards > 1``,
``--num-hosts > 1``) exit with an error instead of running elsewhere.
The port reads stores written by ``uvaia_tpu ingest``.
"""

from __future__ import annotations

import argparse
import sys

from uvaia_tpu.cli.main import _add_nearest

from . import __version__


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="uvaia_tpu_torch",
        description="uvaia nearest-neighbour search on PyTorch + CUDA")
    ap.add_argument("-v", "--version", action="version",
                    version=f"uvaia_tpu_torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = _add_nearest(sub)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default): the hand-written kernels; cpu: "
                        "their plain PyTorch versions")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .engine.nearest import NOT_PORTED, NearestConfig, run_nearest
    if args.num_hosts > 1:
        raise SystemExit(f"--num-hosts {args.num_hosts} is {NOT_PORTED}")
    cfg = NearestConfig(
        nbest=args.nbest, trim=args.trim, acgt=args.acgt,
        keep_resolved=args.keep_resolved, exclude_self=args.exclude_self,
        query_ambiguity=args.query_ambiguity,
        ref_ambiguity=args.ref_ambiguity, pool=args.pool,
        output=args.output, n_devices=args.devices,
        site_shards=args.site_shards, checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every, prune=not args.no_prune,
        codec=args.codec, device=args.device)
    try:
        run_nearest(args.reference, args.fasta, cfg)
    except FileNotFoundError as e:
        print(f"uvaia_tpu_torch: cannot open {e.filename}: {e.strerror}",
              file=sys.stderr)
        return 2
    return 0
