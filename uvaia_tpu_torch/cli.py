"""Command line of the PyTorch port: ``python -m uvaia_tpu_torch
nearest|align``.

The flags are uvaia_tpu's own (the subcommand parsers of
``uvaia_tpu.cli.main``), plus ``--device {cuda,cpu}``; ``nearest`` runs
in full mode and with ``--acgt``.  Options whose paths are not ported
yet (``--devices > 1``, ``--site-shards > 1``, ``--num-hosts > 1``)
exit with an error instead of running elsewhere.
The port reads stores written by ``uvaia_tpu ingest``.  Exit codes are
uvaia_tpu's: 2 for a file that cannot be opened or written, 130 on
interrupt, and a quiet 0 when a reader closes the output pipe.
"""

from __future__ import annotations

import argparse
import os
import sys

from uvaia_tpu.cli.main import _add_align, _add_nearest

from . import __version__


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="uvaia_tpu_torch",
        description="uvaia search and alignment on PyTorch + CUDA")
    ap.add_argument("-v", "--version", action="version",
                    version=f"uvaia_tpu_torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for add in (_add_nearest, _add_align):
        add(sub).add_argument(
            "--device", default="cuda", choices=["cuda", "cpu"],
            help="cuda (default): the hand-written kernels; cpu: their "
                 "plain PyTorch versions")
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
    from .engine.nearest import NOT_PORTED, NearestConfig, run_nearest
    if args.num_hosts > 1:
        raise SystemExit(f"--num-hosts {args.num_hosts} is {NOT_PORTED}")
    run_nearest(args.reference, args.fasta, NearestConfig(
        nbest=args.nbest, trim=args.trim, acgt=args.acgt,
        keep_resolved=args.keep_resolved, exclude_self=args.exclude_self,
        query_ambiguity=args.query_ambiguity,
        ref_ambiguity=args.ref_ambiguity, pool=args.pool,
        output=args.output, n_devices=args.devices,
        site_shards=args.site_shards, checkpoint=args.checkpoint,
        checkpoint_every=args.checkpoint_every, prune=not args.no_prune,
        codec=args.codec, device=args.device))
    return 0
