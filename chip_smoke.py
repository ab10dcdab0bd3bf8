"""Smoke test of the PyTorch port (uvaia_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line):
  0. environment: card name and power limit, torch / CUDA versions, the
     codecs of the port's native IO library (built with g++); fails
     without CUDA or without that library;
  1. build the CUDA kernels from uvaia_tpu_torch/csrc with nvcc (one
     process a source, all started together);
  2. each kernel against its plain PyTorch version on the card, exact
     equality, at the shapes of the main path (B=4096 references of
     L=29903 sites; the full-mode, --acgt and pair counters at Q = 7, 64,
     129 and 1000), with CUDA-event times of both, of the library
     yardstick where one exists (the counters and corrections as one-hot
     int8 products through torch._int_mm, checked equal to the kernel's
     counters first; for the corrections, a kernel of microseconds, also
     kernel and yardstick inside a CUDA graph, without the host's work)
     and each kernel's roofline bound from its shapes;
  3. `nearest` end to end on the card against an independent numpy
     oracle (L=29903, Q=8, 2048 references, k=10), in full mode and
     with --acgt;
  4. `nearest` through its command line at scale: 16384 synthetic
     SARS-CoV-2-length genomes, 64 queries with ambiguity codes,
     nbest=100, pool=4096, prune on and off, in full mode and then with
     --acgt — byte-equal CSVs within each mode, and every launch counter
     of the mode's kernels > 0 over its two runs;
  5. device-resident scan-step rate at L=29903, Q=64, B=4096, k=50, in
     full mode and with --acgt;
  6. `align_batch` and the score-only forward on the card against an
     O(nm) numpy oracle (n=400, 16 queries with SNPs and indels);
  7. `align` through its command line at scale: 2048 synthetic
     SARS-CoV-2-length queries against a 29,903-bp reference, pool 1024
     (SNPs, N runs, indels, truncated ends, QC rejects, an event-capacity
     overflow row, a row that escapes the first bands) — every branch
     taken, every row certified, `gotoh_forward` launched, and the first
     64 QC-passing rows (SNPs and indels, the first band level)
     byte-equal to a `--device cpu` run of the port on a 64-query file
     (run in a child process, from phase 1 on);
  8. `ball` through its command line on phase 4's files (16384 genomes,
     64 queries; raw output) at a radius that keeps a share of the rows:
     the delta step (through delta_rebuild) and the packed step both
     taken; on the first 2048 genomes the kept `.aln.xz` byte-equal
     under `--device cuda` and `--device cpu`, and the kept names equal
     to a numpy restatement of the staged keep rule;
  9. `legacy` through its command line: those 2048 references x 64
     queries, the printed table and the score store equal under
     `--device cuda` and `--device cpu`, the counters of 64 x 8 pairs
     equal to a numpy oracle;
 10. the store and `cluster`: `ingest` of phase 4's 16384 genomes with
     the port (block 4096, the native digest), `info --verify --json`
     exit 0 and ok, the store's rows 0-2047 and the far row equal to the
     FASTA, `nearest` from the store (full mode, prune on) byte-equal to
     phase 4's FASTA CSV; `cluster -d 38 -p 1024` at scale from the
     FASTA and from the store, byte-equal, with more than 1024 medoids
     (the store grows a tier) and rows that join; on the first 2048
     genomes byte-equal under `--device cuda` and `--device cpu`; the
     distance product (torch._int_mm) timed at its main-path shape
     against its int8 bound;
 11. the mesh and several processes, every shard on cuda:0 (the mesh's
     device lookup, parallel/mesh.local_devices, names it n times): at
     L=29903, Q=64 (phase 4's queries), B=4096, k=50, over 4 batches of
     phase 4's genomes (delta and packed payloads), full mode and
     --acgt, at (db, site) = (4,1), (2,2), (1,4), the sharded step's
     state and is_best bit-equal to scan_step_delta / scan_step_packed
     on one device at every batch, and the survivor path (prune_acc,
     prune_acc_delta, flush) equal to the dense state; a sharded delta
     step timed at each shape beside the one-device step (the shards
     share one card and run one after another: the mesh's overhead);
     `run_nearest(n_devices=4, site_shards=2)` on phase 4's genomes
     (full mode, prune on) and `nearest --num-hosts 2` through the
     command line (two child processes on the card, a gloo rendezvous on
     a free port, a timeout each) on phase 10's store split by rows and
     on phase 4's genomes as two FASTA files: each CSV byte-equal to
     phase 4's.
Phase 2 holds delta_rebuild at the main path's batch (E=128, markers on
every row) and on synthetic entries at E = 1024 and 4096, with int32
positions and at the ragged width w = L; each shape is also timed inside
a CUDA graph (`device_ms`: a call of ~0.1 ms is half host work).
Phase 2 also holds amb_corr at the Q=1000 pack (its own number of
ambiguity columns, logged) and the two banded Gotoh kernels against
their plain versions: B=64 at the first band level W=129 and B=4 at
W=4097 at the full reference length, and B=256 at W=129 (the main
path's largest first-band dispatch) and the two widths either side of
the kernel's one-warp / several-warps switch, which are timed at the
full length but held against the plain version on the first 2,000
reference bases (the plain version is a Python loop of ~0.5 ms a row).
Each
kernel's launch count comes from the path that runs it: the nearest
kernels from phase 4 (full-mode ones from its full-mode pair, the
--acgt ones from its --acgt pair; delta_rebuild from phase 4, phase
8's `ball` run and phase 10's three `cluster` runs on the card
together), `gotoh_score` from phase 6, `gotoh_forward` from phase 7,
every count set to 0 just before its runs; to the counts of
delta_rebuild, score_counters, amb_corr and acgt_counters phase 11 adds
the launches of its sharded calls (the mesh steps, the survivor ops
and the `--devices 4 --site-shards 2` run, counted around those calls
only; the --num-hosts children's launches are their own processes').  No command runs `pair_counters` (nor, in the JAX package, the
kernel it replaces): its count is its phase-2 launches.
The line before the last is the card's `name, power.limit`; the line
before it the kernels' JSON record (times at Q=64 and the first Gotoh
band level, the other shapes under `other_shapes`; `bound_ms` the
largest of the bytes over 3.35 TB/s, the operations over their peak rate
and, for the Gotoh rows, the serial chain of `bound`; `library_ms` null
where no single PyTorch call computes the function); the last line is
the result.
Data comes from fixed seeds; files go to build/chip_smoke/ and are
removed at the end.
"""

from __future__ import annotations

import contextlib
import io
import json
import lzma
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from uvaia_tpu_torch.cli import main as cli_main
from uvaia_tpu_torch.engine import align
from uvaia_tpu_torch.engine.nearest import NearestConfig, run_nearest
from uvaia_tpu_torch.engine.query import build_query_pack
from uvaia_tpu_torch.io import native
from uvaia_tpu_torch.ops import _build, gotoh, gotoh_kernels, host, recon
from uvaia_tpu_torch.ops import scan, score_kernels

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
L_SITES = 29903
BATCH = 4096

# IUPAC letters and their 4-bit codes (A=1, C=2, G=4, T=8, N/gap = 0)
_CODES = {"A": 1, "C": 2, "G": 4, "T": 8, "M": 3, "R": 5, "W": 9, "S": 6,
          "Y": 10, "K": 12, "V": 7, "H": 11, "D": 13, "B": 14, "N": 0,
          "-": 0}
LUT = np.zeros(256, dtype=np.uint8)
for _ch, _c in _CODES.items():
    LUT[ord(_ch)] = _c
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AMBIG = np.frombuffer(b"RYKMSWBDHV", dtype=np.uint8)

KERNELS = {
    "score_counters": dict(
        source="uvaia_tpu_torch/csrc/score.cu",
        replaces="uvaia_tpu/ops/pallas_score.py:107",
        wrapper=score_kernels.score_counters),
    "score_counters_packed": dict(
        source="uvaia_tpu_torch/csrc/score.cu",
        replaces="uvaia_tpu/ops/pallas_score.py:463",
        wrapper=score_kernels.score_counters_packed),
    "amb_corr": dict(
        source="uvaia_tpu_torch/csrc/corr.cu",
        replaces="uvaia_tpu/ops/pallas_score.py:239",
        wrapper=score_kernels.amb_corr),
    "delta_rebuild": dict(
        source="uvaia_tpu_torch/csrc/recon.cu",
        replaces="uvaia_tpu/ops/pallas_recon.py:37",
        wrapper=recon.delta_rebuild),
    "gotoh_forward": dict(
        source="uvaia_tpu_torch/csrc/gotoh.cu",
        replaces="uvaia_tpu/ops/pallas_gotoh.py:143",
        wrapper=gotoh_kernels.gotoh_forward),
    "gotoh_score": dict(
        source="uvaia_tpu_torch/csrc/gotoh.cu",
        replaces="uvaia_tpu/ops/pallas_gotoh.py:33",
        wrapper=gotoh_kernels.gotoh_score),
    "acgt_counters": dict(
        source="uvaia_tpu_torch/csrc/acgt.cu",
        replaces="uvaia_tpu/ops/pallas_score.py:334",
        wrapper=score_kernels.acgt_counters),
    "acgt_counters_packed": dict(
        source="uvaia_tpu_torch/csrc/acgt.cu",
        replaces="uvaia_tpu/ops/pallas_score.py:599",
        wrapper=score_kernels.acgt_counters_packed),
    "pair_counters": dict(
        source="uvaia_tpu_torch/csrc/score.cu",
        replaces="uvaia_tpu/ops/pallas_score.py:83",
        wrapper=score_kernels.pair_counters),
}
NEAREST_KERNELS = ("score_counters", "score_counters_packed", "amb_corr",
                   "delta_rebuild")
ACGT_KERNELS = ("acgt_counters", "acgt_counters_packed")
N_REF = 29903          # the SARS-CoV-2 reference length
SUBSET = 2048          # references of the cuda-vs-cpu runs of ball, legacy
# phase 8's radius: a reference sits ~19 base differences and ~3
# ambiguity-code mismatches from the query it was derived from
BALL_RADIUS = 22

# Roofline rates of one H100 SXM: dense int8 tensor cores and HBM3 from
# NVIDIA's data sheet; the CUDA-core int32 rate as 132 SMs x 64 int32
# lanes x the 1.98 GHz boost clock.
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
# integer operations per banded Gotoh cell: three adds, four mins and the
# substitution select, plus two for the traceback bits (forward only)
GOTOH_CELL_OPS = {"gotoh_forward": 10, "gotoh_score": 8}
# Clocks between an integer add or min and an instruction that uses its
# result, as microbenchmarks of Volta and later cards report it (Jia et
# al., "Dissecting the NVIDIA Volta GPU Architecture via
# Microbenchmarking", 2018: 4 cycles), at the 1.98 GHz boost clock.
DEPENDENT_OP_CLOCKS = 4
CLOCK_HZ = 1.98e9


def gotoh_chain_ops(n: int, W: int) -> int:
    """Dependent integer operations of the banded Gotoh recurrence, from
    the recurrence and not from any implementation: DP row i needs row
    i - 1, and inside a row the critical path is m (add), g (min), the
    prefix minimum over the band (ceil(log2 W) mins, however many lanes
    share it), y (add), h (min) and the clamp or mask: 5 + ceil(log2 W)
    operations, n rows one after the other."""
    return n * (5 + (W - 1).bit_length())


def bound(nbytes: int, int8_ops: float = 0.0, int32_ops: float = 0.0,
          chain_ops: int = 0) -> dict:
    """The least time the card could take: the largest of the bytes over
    the memory rate, the operations over their peak rate and, where the
    work is a serial chain, its dependent operations at the card's
    latency from one integer operation to the next that needs it."""
    t_bytes = nbytes / BYTES_PER_S * 1e3
    t_ops = max(int8_ops / INT8_OPS_PER_S, int32_ops / INT32_OPS_PER_S) * 1e3
    t_chain = chain_ops * DEPENDENT_OP_CLOCKS / CLOCK_HZ * 1e3
    by = max((t_bytes, "bytes"), (t_ops, "operations"), (t_chain, "chain"))
    return dict(bound_ms=by[0], bound_by=by[1], bytes_ms=t_bytes,
                operations_ms=t_ops, chain_ms=t_chain)


def counter_bound(r, q_ops, planes: int, n_out: int, cons: bool) -> dict:
    """Bound of a counter kernel: 2 * B * Q * planes * W int8 operations
    (its feature-plane products); each input read once, each output
    written once."""
    B, (Q, W) = r.shape[0], q_ops[0].shape
    nbytes = (r.numel() + sum(x.numel() for x in q_ops) + n_out * B * Q * 4
              + (W + 5 * B * 4 if cons else 0))
    return bound(nbytes, int8_ops=2.0 * B * Q * planes * W)


# ----------------------------------------------------------------------
# the library yardstick: one-hot feature planes through torch._int_mm
# (int8 x int8 -> int32 on the tensor cores).  Operands are built before
# the timed window; the port calls _int_mm only for cluster's distances.

AMB_CODES = [c for c in range(16) if bin(c).count("1") >= 2]


def _i8(planes) -> torch.Tensor:
    return torch.cat([p.to(torch.int8) for p in planes], dim=1)


def _pad8(x: torch.Tensor) -> torch.Tensor:
    """Rows padded with code 0 to a multiple of 8 (_int_mm's N)."""
    return torch.nn.functional.pad(x, (0, 0, 0, -x.shape[0] % 8))


def _onehot(c):
    return [c == (1 << k) for k in range(4)]


def _bits(c):
    return [(c >> k) & 1 for k in range(4)]


def _pure(c):
    return (c != 0) & ((c & (c - 1)) == 0)


def library_products(pairs):
    """A callable computing each (refs (B, K), queries (N, K)) int8 pair
    with torch._int_mm."""
    def run():
        return [torch._int_mm(a, b.t()) for a, b in pairs]
    return run


def library_full(r, q):
    """aa, mm, vv as three _int_mm products (pure one-hot 4W deep, mask
    bits 4W deep, non-zero W deep)."""
    qp = _pad8(q)
    return library_products([(_i8(_onehot(r)), _i8(_onehot(qp))),
                             (_i8(_bits(r)), _i8(_bits(qp))),
                             (_i8([r != 0]), _i8([qp != 0]))])


def library_acgt(r, q_full, q_poly):
    """pp, ppp and aa, aap as two _int_mm products over the pure plane
    and the four pure one-hot planes, q_full and q_poly side by side."""
    qq = torch.cat([_pad8(q_full), _pad8(q_poly)])
    return library_products([(_i8([_pure(r)]), _i8([_pure(qq)])),
                             (_i8(_onehot(r)), _i8(_onehot(qq)))])


def library_corr(ra, qa):
    """corr_t and corr_p as two _int_mm products over the ambiguity
    one-hot planes of the references (11 codes x A columns): against the
    queries' one-hot planes, and against their weights [(a & q) != 0] -
    popcount(a & q) on ambiguous q."""
    qp = _pad8(qa).to(torch.int32)
    q_amb = (qp & (qp - 1)) != 0
    weights = []
    for a in AMB_CODES:
        inter = qp & a
        pc = sum((inter >> k) & 1 for k in range(4))
        weights.append(torch.where(q_amb, (inter != 0).to(torch.int32) - pc,
                                   0))
    ref = _i8([ra == a for a in AMB_CODES])
    return library_products([(ref, _i8([qp == a for a in AMB_CODES])),
                             (ref, _i8(weights))])


def library_equal(got, want) -> None:
    """The yardstick's products, cut to the real queries, against the
    kernel's counters: the library call computes the same function."""
    for g, w in zip(got, want, strict=True):
        if not torch.equal(g, w):
            raise AssertionError("the _int_mm yardstick does not compute "
                                 "the kernel's counters")


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# synthetic data (letters, as FASTA holds them)


def make_genomes(rng, n: int, L: int, parents: np.ndarray, snps: int,
                 amb: int, n_runs: int) -> np.ndarray:
    """(n, L) uint8 letters: a random parent row each, plus `snps`
    random bases, `amb` ambiguity codes, `n_runs` runs of N (5-400
    sites) and, on every fourth row, a masked tail."""
    out = parents[rng.integers(0, len(parents), n)].copy()
    rows = np.repeat(np.arange(n), snps)
    out[rows, rng.integers(0, L, n * snps)] = ACGT[rng.integers(0, 4, n * snps)]
    rows = np.repeat(np.arange(n), amb)
    out[rows, rng.integers(0, L, n * amb)] = AMBIG[rng.integers(0, 10, n * amb)]
    for r in range(n):
        for _ in range(n_runs):
            s = int(rng.integers(0, L - 400))
            out[r, s:s + int(rng.integers(5, 400))] = ord("N")
        if r % 4 == 0:
            out[r, L - int(rng.integers(20, 300)):] = ord("N")
    return out


def write_fasta(path: Path, prefix: str, letters: np.ndarray) -> None:
    with open(path, "wb") as f:
        for i in range(0, len(letters), 1024):
            f.write(b"".join(b">%s%d\n%s\n" % (prefix.encode(), i + j,
                                                row.tobytes())
                             for j, row in enumerate(letters[i:i + 1024])))


def query_set(rng, L: int, q: int) -> np.ndarray:
    """(q, L) query letters around one random backbone."""
    backbone = ACGT[rng.integers(0, 4, L)]
    return make_genomes(rng, q, L, backbone[None, :], snps=30, amb=4,
                        n_runs=1)


# ----------------------------------------------------------------------
# timing


def timed_ms(fn, reps: int = 7) -> float:
    """Median milliseconds of fn() over `reps` runs after one warm-up,
    from CUDA events on the card."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def timed_graph_ms(fn, calls: int = 20) -> float:
    """Device milliseconds a call: `calls` calls of fn captured in one
    CUDA graph and replayed, so no host work lies between the launches
    (for a kernel of microseconds, whose call is mostly host work)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return timed_ms(graph.replay) / calls


def max_err(a, b) -> float:
    """Largest absolute difference over parallel tuples of tensors;
    raises if any shape differs or any value is not equal."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    err = 0.0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    if err != 0.0:
        raise AssertionError(f"kernel and plain version differ by {err}")
    return err


# ----------------------------------------------------------------------
# phases


def check_kernel(name: str, fn, plain, args, shape: str, bnd: dict,
                 library=None, plain_once: bool = False,
                 device_only: bool = False) -> dict:
    """fn(*args) against plain(*args) on the same tensors, exactly, with
    CUDA-event times of both and of the library yardstick (library =
    (run, check): check(kernel outputs, run()) raises unless the library
    call computes the same counters); logs one line, returns the record
    fields.  plain_once: the plain version runs once, timed, for both
    (a plain version of seconds a call).  device_only: also the device
    time of the kernel (and the library call) inside a CUDA graph."""
    out = fn(*args)
    want, plain_ms = timed_once(lambda: plain(*args))
    err = max_err(out, want)
    del want
    library_ms = None
    if library is not None:
        run_lib, check = library
        check(out, run_lib())
        library_ms = timed_ms(run_lib)
    del out
    ms = timed_ms(lambda: fn(*args))
    if not plain_once:
        plain_ms = timed_ms(lambda: plain(*args), reps=3)
    lib_txt = "none" if library_ms is None else f"{library_ms:.3f} ms"
    extra = {}
    if device_only:
        extra = dict(device_ms=timed_graph_ms(lambda: fn(*args)))
        lib_txt += f" (on the device alone: kernel {extra['device_ms']:.4f} ms"
        if library is not None:
            extra["library_device_ms"] = timed_graph_ms(library[0])
            lib_txt += f", library {extra['library_device_ms']:.4f} ms"
        lib_txt += ")"
    log(f"  {name} {shape}: max_abs_err={err} kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, library {lib_txt}, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(shape=shape, max_abs_err=err, ms=ms, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, **extra, **bnd)


def phase_kernels(dev, rng, B: int, L: int, qs_list, records: dict) -> None:
    """Each nearest kernel vs its plain version on the same tensors: the
    full-mode and --acgt counters (unpacked and packed) and the pair
    counters at every Q, the corrections at the Q=64 and the Q=1000 pack
    (the columns where any query is ambiguous: more queries, more
    columns) and the rebuild at Q=64; the counters and corrections also
    against their _int_mm yardstick."""
    sk = score_kernels
    queries = query_set(rng, L, max(qs_list))
    refs = make_genomes(rng, B, L, queries, snps=20, amb=3, n_runs=2)
    codes = LUT[refs]
    packed_d = torch.from_numpy(host.pack_codes(codes)).to(dev)
    sk.pair_counters.launches = 0
    for Q in qs_list:
        qpath = WORK / f"k_q{Q}.fa"
        write_fasta(qpath, "q", queries[:Q])
        for acgt in (False, True):
            pack = build_query_pack(str(qpath), acgt=acgt)
            qd = scan.build_device_data(pack, k=10, device=dev)
            r = scan._to_width(torch.from_numpy(codes).to(dev), qd.width)
            nq = pack.n_query
            if acgt:
                names = ACGT_KERNELS
                plains = (sk.acgt_counters_plain,
                          sk.acgt_counters_packed_plain)
                q_args = (qd.q_full, qd.q_poly, qd.cons_full)
                planes, n_out = 10, 4
                qp8 = -nq % 8 + nq
                lib = (library_acgt(r, qd.q_full, qd.q_poly),
                       lambda o, g: library_equal(
                           [g[0][:, :nq], g[0][:, qp8:qp8 + nq],
                            g[1][:, :nq], g[1][:, qp8:qp8 + nq]],
                           [o[0], o[2], o[1], o[3]]))
            else:
                names = ("score_counters", "score_counters_packed")
                plains = (sk.score_counters_plain,
                          sk.score_counters_packed_plain)
                q_args = (qd.q_full, qd.cons_full)
                planes, n_out = 9, 3
                lib = (library_full(r, qd.q_full),
                       lambda o, g: library_equal(
                           [x[:, :nq] for x in g], o[:3]))
                full = (qd, r)
            recs = [check_kernel(
                        name, KERNELS[name]["wrapper"], plain,
                        (rows, *q_args), f"B={B} {dim} Q={nq}",
                        counter_bound(rows, q_args[:-1], planes, n_out,
                                      True), lib)
                    for name, plain, rows, dim in zip(
                        names, plains, (r, packed_d),
                        (f"W={qd.width}", f"P={packed_d.shape[1]}"))]
            del lib
            if Q == 64:
                for name, rec in zip(names, recs):
                    records[name].update(rec)
        # the pair counters at the natural site count (the wrapper pads
        # to 64 sites)
        qd, r = full
        rows = torch.from_numpy(codes).to(dev)
        qs = qd.q_full[:, :L].contiguous()
        nq = qd.n_query
        rec = check_kernel(
            "pair_counters", sk.pair_counters, sk.pair_counters_plain,
            (rows, qs), f"B={B} S={L} Q={nq}",
            counter_bound(rows, (qs,), 9, 3, False),
            (library_full(r, qd.q_full),
             lambda o, g: library_equal([x[:, :nq] for x in g], o)))
        if Q == 64:
            records["pair_counters"].update(rec)
        if Q not in (64, 1000):
            continue
        if qd.amb_sites is None:
            raise AssertionError(f"the Q={Q} pack has no ambiguity column")
        ra = scan._take_fill(r, qd.amb_sites)
        qa = scan._take_fill(qd.q_full, qd.amb_sites)
        A = ra.shape[1]
        rec = check_kernel(
            "amb_corr", sk.amb_corr, sk.amb_corr_plain, (ra, qa),
            f"B={B} A={A} Q={nq}",
            bound(ra.numel() + qa.numel() + 2 * B * nq * 4,
                  int8_ops=2.0 * B * nq * 2 * len(AMB_CODES) * A),
            (library_corr(ra, qa),
             lambda o, g: library_equal([x[:, :nq] for x in g], o)),
            plain_once=Q != 64, device_only=True)
        del ra, qa
        if Q != 64:
            records["amb_corr"].setdefault("other_shapes", []).append(rec)
            continue
        records["amb_corr"].update(rec)
        phase_rebuild(dev, codes, qd, records)
    # no command runs the pair counters: their count is their launches
    # in this phase
    records["pair_counters"]["launches"] = sk.pair_counters.launches


def synthetic_deltas(rng, B: int, E: int, L: int, pos_dtype=np.uint16):
    """(pos (B, E), val (B, E)) as the encoder orders them: E/2..E real
    entries a row at ascending unique positions, then padding at
    pos = L + slot.  Odd rows carry run markers on ~3% of their entries,
    starts and ends in turn; row 1 ends on a start (a run to the row
    end) and row 3 holds two starts in a row (a nested one)."""
    stride = L // E
    pos = (np.arange(E, dtype=np.int64) * stride)[None, :] \
        + rng.integers(0, stride, (B, E))
    val = rng.integers(0, 16, (B, E)).astype(np.uint8)
    mark = rng.random((B, E)) < 0.03
    mark[0::2] = False
    order = np.cumsum(mark, axis=1)
    val[mark & (order % 2 == 1)] = 16
    ends = mark & (order % 2 == 0)
    val[ends] = 32 + rng.integers(0, 16, int(ends.sum()))
    slots = np.arange(E)[None, :]
    real = slots < rng.integers(E // 2, E + 1, (B, 1))
    if B > 3:
        real[[1, 3], :E // 2] = True
        val[1, E // 2 - 1] = 16
        val[3, 4:6] = 16
    pos = np.where(real, pos, L + slots)
    val[~real] = 0
    return pos.astype(pos_dtype), val


def rebuild_bound(pos, val, L: int, width: int) -> dict:
    """Entries and base read once, the rows written once."""
    return bound(pos.numel() * pos.element_size() + val.numel() + L
                 + pos.shape[0] * width)


def phase_rebuild(dev, codes: np.ndarray, qd, records: dict) -> None:
    """delta_rebuild on a delta-encoded batch with SNPs, N-runs (zero-run
    markers on every row), masked tails and an ok=False row, as phase 4
    feeds it; then on synthetic entries at E = 1024 and 4096, with int32
    positions and at the ragged width w = L (odd rows with markers, an
    open and a nested run among them)."""
    B, L = codes.shape
    ok = np.ones(B, dtype=bool)
    ok[B // 2] = False
    base = qd.delta_base.cpu().numpy()
    enc = host.delta_encode(codes, ok, base)
    if enc is None:
        raise AssertionError("the rebuild batch did not fit the delta buckets")
    pos, val = (torch.from_numpy(x).to(dev) for x in enc)
    if not bool((val >= 16).any()):
        raise AssertionError("the rebuild batch has no zero-run marker")
    args = (pos, val, qd.delta_base, qd.width)
    out = recon.delta_rebuild(*args)
    want = np.where(ok[:, None], codes, base[None, :])
    if not np.array_equal(out[:, :L].cpu().numpy(), want):
        raise AssertionError("delta_rebuild did not give back the rows")
    rng = np.random.default_rng(64)

    def check(args):
        pos, val, base_d, width = args
        return check_kernel(
            "delta_rebuild", recon.delta_rebuild, recon.delta_rebuild_plain,
            args, f"B={pos.shape[0]} E={pos.shape[1]} w={width} "
            f"pos={str(pos.dtype).split('.')[-1]}",
            rebuild_bound(pos, val, base_d.shape[0], width),
            device_only=True)

    records["delta_rebuild"].update(check(args))
    for E, dt, width in ((1024, np.uint16, qd.width),
                         (4096, np.uint16, qd.width),
                         (128, np.int32, qd.width), (128, np.uint16, L)):
        p, v = (torch.from_numpy(x).to(dev)
                for x in synthetic_deltas(rng, B, E, L, dt))
        records["delta_rebuild"].setdefault("other_shapes", []).append(
            check((p, v, qd.delta_base, width)))


PURE = np.isin(np.arange(16), (1, 2, 4, 8))


def rank_topk(scores: np.ndarray, k: int):
    """(B, 6) scores -> the top k rows by lexicographic order, ties to
    the lower index: (scores (k, 6), idx (k,))."""
    order = np.lexsort(tuple(-scores[:, j] for j in range(5, -1, -1)))[:k]
    return scores[order], order


def oracle_topk(codes: np.ndarray, pack, k: int):
    """Independent numpy oracle: six scores from their definitions over
    the query pack's site classes, top-k by lexicographic order with
    ties to the lower index.  Returns (scores (Q, k, 6), idx (Q, k))."""
    def counters(a, r):                        # a (S,), r (B, S)
        valid = (a != 0) & (r != 0)
        eq = (a == r) & valid
        pure = np.isin(a, (1, 2, 4, 8))
        return ((eq & pure).sum(1), eq.sum(1), ((a & r) != 0).sum(1),
                valid.sum(1))
    idx_c, idx_mq = pack.idx_c, pack.idx_mq
    c = counters(pack.consensus[idx_c], codes[:, idx_c])
    valid_ref = (codes != 0).sum(1)
    out = [rank_topk(np.stack([c[j] + m[j] for j in range(4)]
                              + [m[0], valid_ref], axis=1), k)
           for m in (counters(pack.codes[qi, idx_mq], codes[:, idx_mq])
                     for qi in range(pack.n_query))]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def oracle_topk_acgt(codes: np.ndarray, pack, k: int):
    """oracle_topk for --acgt: ACGT mismatches and valid ACGT pairs over
    the consensus sites, idx_m and the polymorphic idx, assembled as
    uvaia's nearest.c:443-477 does (s4 = mismatches over the consensus
    sites and idx_m, s5 = mismatches over idx)."""
    def mismatches(a, r):                      # a (S,), r (B, S)
        both = PURE[a][None, :] & PURE[r]
        return (both & (a[None, :] != r)).sum(1), both.sum(1)
    mm_c, va_c = mismatches(pack.consensus[pack.idx_c],
                            codes[:, pack.idx_c])
    valid_ref = (codes != 0).sum(1)
    out = []
    for a in pack.codes:
        mm_m, va_m = mismatches(a[pack.idx_m], codes[:, pack.idx_m])
        mm_p, va_p = mismatches(a[pack.idx], codes[:, pack.idx])
        va = va_c + va_m + va_p
        matches = va - (mm_c + mm_m + mm_p)
        out.append(rank_topk(np.stack(
            [matches, va, matches - (va_c - mm_c), valid_ref, mm_c + mm_m,
             mm_p], axis=1), k))
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def phase_oracle(dev, rng, L: int) -> None:
    Q, n, k = 8, 2048, 10
    queries = query_set(rng, L, Q)
    refs = make_genomes(rng, n, L, queries, snps=15, amb=2, n_runs=1)
    # keep what the reference QC keeps (at least half the sites valid),
    # so database indices are row numbers
    refs = refs[(LUT[refs] != 0).sum(1) >= L // 2]
    write_fasta(WORK / "o_q.fa", "q", queries)
    write_fasta(WORK / "o_db.fa", "r", refs)
    for acgt, oracle in ((False, oracle_topk), (True, oracle_topk_acgt)):
        t0 = time.perf_counter()
        res = run_nearest([str(WORK / "o_db.fa")], str(WORK / "o_q.fa"),
                          NearestConfig(nbest=k, pool=512, device=str(dev),
                                        acgt=acgt,
                                        output=str(WORK / "o_out")))
        pack = build_query_pack(str(WORK / "o_q.fa"), acgt=acgt)
        want_s, want_i = oracle(LUT[refs], pack, k)
        mode = "nearest --acgt" if acgt else "nearest"
        if not (np.array_equal(res.indices, want_i)
                and np.array_equal(res.scores, want_s)):
            raise AssertionError(f"{mode} top-k differs from the oracle")
        log(f"  {mode} vs oracle: L={L} Q={Q} refs={n} k={k}: top-k "
            f"indices and scores equal ({time.perf_counter() - t0:.3f} s)")


def phase_scale(dev, rng, n: int, L: int, Q: int, nbest: int,
                pool: int) -> dict:
    """Two CLI runs (prune on / off) at scale in full mode, then two with
    --acgt, on the same files; returns the launch counts, each kernel's
    over the two runs of its mode."""
    queries = query_set(rng, L, Q)
    refs = make_genomes(rng, n, L, queries, snps=25, amb=3, n_runs=2)
    # one row far from every query: more diffs than the largest delta
    # bucket, so its batch travels packed
    far = refs[n - pool // 2]
    far[rng.permutation(L)[:3 * L // 10]] = ACGT[rng.integers(0, 4, 3 * L // 10)]
    q_fa, db_fa = WORK / "s_q.fa", WORK / "s_db.fa"
    write_fasta(q_fa, "q", queries)
    write_fasta(db_fa, "r", refs)
    write_fasta(WORK / "s_db_sub.fa", "r", refs[:SUBSET])   # phases 8, 9
    del refs
    counts = {}
    for acgt, names in ((False, NEAREST_KERNELS), (True, ACGT_KERNELS)):
        counts.update(scale_pair(dev, q_fa, db_fa, n, L, Q, nbest, pool,
                                 acgt, names))
    return counts


def scale_pair(dev, q_fa: Path, db_fa: Path, n: int, L: int, Q: int,
               nbest: int, pool: int, acgt: bool, names) -> dict:
    """One mode's prune / --no-prune pair: byte-equal CSVs of 1 + Q*nbest
    rows under the mode's header, and every kernel in `names` launched
    over the two runs; returns their launch counts."""
    from uvaia_tpu_torch.engine.nearest import CSV_HEADER_ACGT, \
        CSV_HEADER_FULL
    mode_flag = ["--acgt"] if acgt else []
    label = "nearest --acgt" if acgt else "nearest"
    for name in names:
        KERNELS[name]["wrapper"].launches = 0
    csv = {}
    for mode, extra in (("prune", []), ("noprune", ["--no-prune"])):
        out = WORK / f"s_{mode}{'_acgt' if acgt else ''}"
        argv = ["nearest", "-r", str(db_fa), str(q_fa), "-n", str(nbest),
                "-p", str(pool), "-o", str(out), "--device", str(dev),
                *mode_flag, *extra]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli_main(argv) != 0:
            raise AssertionError(f"{label} {mode} failed")
        wall = time.perf_counter() - t0
        csv[mode] = (out.parent / (out.name + ".csv.xz")).read_bytes()
        log(f"  {label} {mode}: {n} genomes x {L} sites, Q={Q}, "
            f"nbest={nbest}, pool={pool}: {wall:.3f} s wall, "
            f"{n / wall:,.1f} genomes/s")
    counts = {name: KERNELS[name]["wrapper"].launches for name in names}
    if csv["prune"] != csv["noprune"]:
        raise AssertionError(f"{label}: prune and --no-prune CSVs differ")
    rows = lzma.decompress(csv["prune"]).decode().split("\n")
    if rows[0] + "\n" != (CSV_HEADER_ACGT if acgt else CSV_HEADER_FULL):
        raise AssertionError(f"{label}: CSV header {rows[0]!r}")
    if len(rows) - 1 != 1 + Q * nbest or rows[-1]:
        raise AssertionError(f"{label}: CSV has {len(rows) - 1} lines, "
                             f"want {1 + Q * nbest}")
    log(f"  {label}: prune and --no-prune CSVs byte-equal "
        f"({len(csv['prune'])} bytes); launches over both runs: {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return counts


def phase_steps(dev, rng, L: int, Q: int, B: int, k: int, steps: int,
                card: str) -> None:
    queries = query_set(rng, L, Q)
    refs = make_genomes(rng, B, L, queries, snps=25, amb=3, n_runs=2)
    write_fasta(WORK / "b_q.fa", "q", queries)
    codes = LUT[refs]
    ok = np.ones(B, dtype=bool)
    ok_d = torch.from_numpy(ok).to(dev)
    packed = torch.from_numpy(host.pack_codes(codes)).to(dev)
    for acgt in (False, True):
        pack = build_query_pack(str(WORK / "b_q.fa"), acgt=acgt)
        qd = scan.build_device_data(pack, k=k, device=dev)
        enc = host.delta_encode(codes, ok, qd.delta_base.cpu().numpy())
        if enc is None:
            raise AssertionError("the step batch did not fit the delta "
                                 "buckets")
        pos, val = (torch.from_numpy(x).to(dev) for x in enc)
        for name, step in (
                ("scan_step_delta",
                 lambda st, i: scan.scan_step_delta(qd, st, pos, val, ok_d,
                                                    i * B)),
                ("scan_step_packed",
                 lambda st, i: scan.scan_step_packed(qd, st, packed, ok_d,
                                                     i * B))):
            state = scan.init_state(pack.n_query, k, device=dev)
            for i in range(3):
                state, _ = step(state, i)
            it = iter(range(3, 3 + steps))
            holder = [state]

            def one():
                holder[0], _ = step(holder[0], next(it))
            ms = timed_ms(one, reps=steps - 1)
            log(f"  {name}{' --acgt' if acgt else ''} L={L} "
                f"Q={pack.n_query} B={B} k={k}: {ms:.3f} ms/step, "
                f"{B / ms * 1e3:,.0f} genomes/s ({card})")

# ----------------------------------------------------------------------
# ball and legacy


def read_letters(path: Path, count: int) -> np.ndarray:
    """(count, L) letters of the first records of a one-line-a-record
    FASTA file."""
    rows = []
    with open(path, "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                rows.append(np.frombuffer(line.rstrip(b"\n"), np.uint8))
                if len(rows) == count:
                    break
    return np.stack(rows)


def ball_oracle_keep(codes: np.ndarray, pack, dist: int) -> np.ndarray:
    """The staged keep rule from its definition (text mode): d_cons over
    the constant sites against the consensus; keep iff 2 d_cons <= dist
    or d_cons + min over queries of the mismatches at the polymorphic
    sites <= dist.  A mismatch: both codes non-zero and different."""
    def mism(a, r):                            # a (S,), r (B, S)
        return ((a != 0) & (r != 0) & (a != r)).sum(1)
    cs = np.concatenate([pack.idx_c, pack.idx_m])
    d_cons = mism(pack.consensus[cs], codes[:, cs])
    d_q = np.stack([mism(q[pack.idx], codes[:, pack.idx])
                    for q in pack.codes], axis=1)
    return (2 * d_cons <= dist) | (d_cons + d_q.min(1) <= dist)


def phase_ball(dev, n: int, pool: int, radius: int) -> int:
    """`ball` at scale on the card, then cuda vs cpu vs the numpy keep
    rule on the first SUBSET genomes; returns delta_rebuild's launches
    over the run at scale."""
    from uvaia_tpu_torch.engine import ball
    q_fa, db_fa, sub_fa = (WORK / x for x in ("s_q.fa", "s_db.fa",
                                              "s_db_sub.fa"))
    stats = {}
    run_ball = ball.run_ball

    def keep_stats(*a, **kw):
        stats["s"] = run_ball(*a, **kw)
        return stats["s"]

    def cli(db, out, device, *extra):
        argv = ["ball", "-r", str(db), str(q_fa), "-d", str(radius), "-p",
                str(pool), "-o", str(WORK / out), "--device", device, *extra]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli_main(argv) != 0:
            raise AssertionError(f"ball {out} failed")
        return time.perf_counter() - t0, stats.pop("s")

    ball.run_ball = keep_stats
    try:
        recon.delta_rebuild.launches = 0
        wall, st = cli(db_fa, "ball_cuda", str(dev), "--codec", "raw")
        launches = recon.delta_rebuild.launches
        log(f"  ball at scale: {n} genomes, Q=64, radius {radius}, pool="
            f"{pool}, raw output: kept {st['kept']} ({st['invalid']} too "
            f"ambiguous), steps {st['steps']}, {wall:.3f} s wall, "
            f"{n / wall:,.1f} genomes/s")
        if st["count"] != n or not 0 < st["kept"] < n:
            raise AssertionError(f"ball kept {st['kept']} of {st['count']}")
        if launches != st["steps"]["delta"] or launches == 0 \
                or st["steps"]["packed"] == 0:
            raise AssertionError(
                f"ball: delta_rebuild launches {launches}, steps "
                f"{st['steps']}: want both steps taken, one launch a "
                f"delta step")
        _, st_cuda = cli(sub_fa, "ball_sub_cuda", str(dev))
        _, st_cpu = cli(sub_fa, "ball_sub_cpu", "cpu")
    finally:
        ball.run_ball = run_ball
    a, b = ((WORK / f"ball_sub_{d}.aln.xz").read_bytes()
            for d in ("cuda", "cpu"))
    if a != b or st_cuda != st_cpu:
        raise AssertionError("ball: cuda and cpu runs differ")
    pack = build_query_pack(str(q_fa), always_exclude_redundant=True)
    want = ball_oracle_keep(LUT[read_letters(sub_fa, SUBSET)], pack, radius)
    kept = [r[:r.index(b"\n")].decode() for r in
            lzma.decompress(a).split(b">")[1:]]
    if kept != [f"r{i}" for i in np.nonzero(want)[0]]:
        raise AssertionError("ball: the kept names differ from the numpy "
                             "keep rule")
    log(f"  ball on the first {SUBSET}: cuda and cpu .aln.xz byte-equal "
        f"({len(a)} bytes), {len(kept)} kept as the numpy keep rule says")
    return launches


def legacy_oracle(q: np.ndarray, r: np.ndarray):
    """(acgt matches, text matches, weighted partial, valid pairs) of two
    code rows, from their definitions, the partial in float64."""
    pop = np.array([bin(c).count("1") for c in range(16)])
    valid = (q != 0) & (r != 0)
    eq = valid & (q == r)
    w = pop[q & r] / np.maximum(pop[q] * pop[r], 1)
    return (int((eq & (pop[q] == 1)).sum()), int(eq.sum()), float(w.sum()),
            int(valid.sum()))


def phase_legacy(dev) -> None:
    """`legacy` on the card and on the CPU: the same table and scores;
    64 x 8 pairs against the numpy oracle."""
    from uvaia_tpu_torch.engine import legacy
    q_fa, sub_fa = WORK / "s_q.fa", WORK / "s_db_sub.fa"
    results = {}
    run_legacy = legacy.run_legacy

    def keep_result(*a, **kw):
        results["r"] = run_legacy(*a, **kw)
        return results["r"]

    legacy.run_legacy = keep_result
    out = {}
    try:
        for device in (str(dev), "cpu"):
            buf = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["legacy", "-r", str(sub_fa), str(q_fa), "-n",
                               "8", "--device", device])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"legacy --device {device} failed")
            out[device] = (buf.getvalue(), results.pop("r"))
            log(f"  legacy --device {device}: {SUBSET} references x 64 "
                f"queries x {L_SITES} sites: {wall:.3f} s wall, "
                f"{SUBSET * 64 / wall:,.0f} pairs/s, table of "
                f"{buf.getvalue().count(chr(10))} lines")
    finally:
        legacy.run_legacy = run_legacy
    (table, (scores, qnames, rnames)), (table_cpu, (scores_cpu, *_)) = \
        out[str(dev)], out["cpu"]
    if table != table_cpu or len(table.split("\n")) < 2 + 64 * 8:
        raise AssertionError("legacy: the cuda and cpu tables differ")
    for a, b in zip(scores, scores_cpu, strict=True):
        if not np.array_equal(a, b):
            raise AssertionError("legacy: cuda and cpu scores differ")
    if len(rnames) != SUBSET or len(qnames) != 64:
        raise AssertionError(f"legacy scored {len(rnames)} x {len(qnames)}")
    refs = LUT[read_letters(sub_fa, 64)]
    queries = LUT[read_letters(q_fa, 64)]
    qrow = {f"q{i}": i for i in range(64)}
    for qi, qname in enumerate(qnames[:8]):
        for ri in range(64):
            a, t, w, v = legacy_oracle(queries[qrow[qname]], refs[ri])
            got = [x[ri, qi] for x in scores]
            if (got[0], got[1], got[3]) != (a, t, v) \
                    or abs(got[2] - w) > 1e-6 * w:
                raise AssertionError(f"legacy scores {got} of {qname} vs "
                                     f"r{ri}: oracle {(a, t, w, v)}")
    log("  legacy: cuda and cpu tables and scores equal; 64 x 8 pairs "
        "equal to the numpy oracle (counters exact, partial to 1e-6)")


# ----------------------------------------------------------------------
# store and cluster


def fasta_rows(path: Path, rows) -> dict:
    """{i: letters of record i} for the record numbers in `rows`, from a
    one-line-a-record FASTA file."""
    want, out, i = set(rows), {}, -1
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                i += 1
                if i > max(want):
                    break
            elif i in want:
                out[i] = line.rstrip(b"\n")
    return out


def phase_store(dev, card: str, n: int) -> None:
    """`ingest` of phase 4's genomes into a store with the port (block
    BATCH, the native digest: phase 0 fails without the library),
    `info --verify --json` on it, its rows
    against the FASTA's, and `nearest` from it byte-equal to phase 4's
    FASTA run (full mode, prune on)."""
    from uvaia_tpu_torch.io import store as store_mod
    db_fa, q_fa, st_dir = WORK / "s_db.fa", WORK / "s_q.fa", WORK / "s_db.uvst"
    t0 = time.perf_counter()
    if cli_main(["ingest", str(db_fa), "-o", str(st_dir), "--block",
                 str(BATCH)]) != 0:
        raise AssertionError("ingest failed")
    wall = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in st_dir.iterdir())
    log(f"  ingest: {n} genomes x {L_SITES} sites, block {BATCH}, native "
        f"digest: {wall:.3f} s, {n / wall:,.1f} genomes/s; store "
        f"{size:,} bytes ({size / n:,.0f} a genome; the FASTA "
        f"{db_fa.stat().st_size:,}) ({card})")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["info", str(st_dir), "--verify", "--json"])
    rec = json.loads(buf.getvalue())
    if rc != 0 or not rec["verify"]["ok"] or rec["n_rows"] != n \
            or rec["n_packed_only_blocks"] < 1 or rec["n_delta_blocks"] < 1:
        raise AssertionError(f"info --verify: rc {rc}, {rec}")
    log(f"  info --verify --json: exit 0, {rec['verify']['checked']} blocks "
        f"checked, {rec['n_delta_blocks']} delta and "
        f"{rec['n_packed_only_blocks']} packed-only")
    far = n - BATCH // 2                 # phase 4's far row: packed-only
    st = store_mod.Store(st_dir)
    for i, row in fasta_rows(db_fa, [*range(SUBSET), far]).items():
        if st.seq_row(i) != row:
            raise AssertionError(f"store row {i} differs from the FASTA")
    log(f"  Store.seq_row equals the FASTA on rows 0-{SUBSET - 1} and {far}")
    names = NEAREST_KERNELS
    for name in names:
        KERNELS[name]["wrapper"].launches = 0
    out = WORK / "s_store"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cli_main(["nearest", "-r", str(st_dir), str(q_fa), "-n", "100", "-p",
                 str(BATCH), "-o", str(out), "--device", str(dev)]) != 0:
        raise AssertionError("nearest from the store failed")
    wall = time.perf_counter() - t0
    counts = {name: KERNELS[name]["wrapper"].launches for name in names}
    got = (WORK / "s_store.csv.xz").read_bytes()
    if got != (WORK / "s_prune.csv.xz").read_bytes():
        raise AssertionError("nearest from the store: the CSV differs from "
                             "phase 4's FASTA run")
    if counts["delta_rebuild"] == 0:
        raise AssertionError("nearest from the store never rebuilt a batch")
    log(f"  nearest from the store: {n} genomes, Q=64, nbest=100, pool="
        f"{BATCH}, prune on: {wall:.3f} s wall, {n / wall:,.1f} genomes/s; "
        f"CSV byte-equal to phase 4's FASTA run; launches {counts} "
        f"({card})")


# phase 10's cluster distance: siblings in phase 4's files (genomes of
# one of the 64 parents) sit 34-46 differences apart (median 42), genomes
# of two parents 76 or more; at 38 about one sibling pair in seven is
# within it, so rows join and found clusters both, and more than 1024
# medoids grow the store past its first tier
CLUSTER_DISTANCE = 38
CLUSTER_POOL = 1024
FIRST_TIER = 1024      # the medoid store's first size (MedoidIndex)


def phase_cluster(dev, card: str, n: int) -> int:
    """`cluster` on the card from phase 4's FASTA and from phase 10's
    store (the same bytes), then on the first SUBSET genomes under
    --device cuda and --device cpu (the same bytes); returns
    delta_rebuild's launches over the card's runs.  Logs each run's rate,
    medoids, tier, merge time and the share of its wall on the card in
    the int8 products and in the feature planes (CUDA events)."""
    from uvaia_tpu_torch.engine import cluster as cl
    real = cl.MedoidIndex, cl._merge_clusters, cl.int8_product
    seen, spans = {}, {"product": [], "planes": []}

    def span(name, fn, *a, **kw):
        if not any(isinstance(x, torch.Tensor) and x.is_cuda for x in a):
            return fn(*a, **kw)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*a, **kw)
        ev[1].record()
        spans[name].append(ev)
        return out

    class Index(real[0]):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["index"] = self

        def planes(self, codes, *a, **kw):
            return span("planes", super().planes, codes, *a, **kw)

    def merge(*a, **kw):
        t0 = time.perf_counter()
        out = real[1](*a, **kw)
        seen["merge_s"] = time.perf_counter() - t0
        return out

    def run_one(src, out, device):
        for v in spans.values():
            v.clear()
        recon.delta_rebuild.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if cli_main(["cluster", str(src), "-d", str(CLUSTER_DISTANCE),
                     "-p", str(CLUSTER_POOL), "-o", str(WORK / out),
                     "--device", device]) != 0:
            raise AssertionError(f"cluster {out} failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = recon.delta_rebuild.launches
        idx = seen.pop("index")
        rows = lzma.decompress((WORK / f"{out}.csv.xz").read_bytes()) \
            .decode().split("\n")[:-1]
        shares = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
                  for k, v in spans.items()}
        log(f"  cluster {out} --device {device}: {wall:.3f} s wall; "
            f"{idx.n} medoids before the merge (store tier {idx.tier}), "
            f"{len(rows)} clusters after it ({seen.pop('merge_s'):.3f} s), "
            f"{sum(r.count(',') for r in rows)} joined rows; "
            f"delta_rebuild launches {launches}; on the card: products "
            f"{shares['product']:.3f} s ({len(spans['product'])} calls), "
            f"feature planes {shares['planes']:.3f} s")
        return wall, idx, launches, shares, rows

    cl.MedoidIndex, cl._merge_clusters = Index, merge
    cl.int8_product = lambda a, b: span("product", real[2], a, b)
    try:
        fa = run_one(WORK / "s_db.fa", "c_fa", str(dev))
        st = run_one(WORK / "s_db.uvst", "c_st", str(dev))
        sub_cuda = run_one(WORK / "s_db_sub.fa", "c_sub_cuda", str(dev))
        sub_cpu = run_one(WORK / "s_db_sub.fa", "c_sub_cpu", "cpu")
    finally:
        cl.MedoidIndex, cl._merge_clusters, cl.int8_product = real
    for (a, b) in (("c_fa", "c_st"), ("c_sub_cuda", "c_sub_cpu")):
        for ext in (".csv.xz", ".aln.xz"):
            if (WORK / (a + ext)).read_bytes() != \
                    (WORK / (b + ext)).read_bytes():
                raise AssertionError(f"cluster: {a}{ext} and {b}{ext} differ")
    wall, idx, _, shares, rows = fa
    if idx.n <= FIRST_TIER or idx.tier <= FIRST_TIER:
        raise AssertionError(f"cluster made {idx.n} medoids (tier "
                             f"{idx.tier}): the store never grew a tier")
    if not 1 < len(rows) < n or not any("," in r for r in rows):
        raise AssertionError(f"cluster: {len(rows)} clusters of {n}")
    launches = [r[2] for r in (fa, st, sub_cuda)]
    if 0 in launches or sub_cpu[2] != 0:
        raise AssertionError(f"cluster: delta_rebuild launches {launches} "
                             f"on the card, {sub_cpu[2]} on the CPU")
    log(f"  cluster at scale: {n} genomes x {L_SITES} sites, -d "
        f"{CLUSTER_DISTANCE}, pool {CLUSTER_POOL}: from the FASTA {wall:.3f} "
        f"s ({n / wall:,.1f} genomes/s), from the store {st[0]:.3f} s "
        f"({n / st[0]:,.1f} genomes/s), .csv.xz and .aln.xz byte-equal; "
        f"products {shares['product'] / wall:.1%} of the FASTA run's wall, "
        f"feature planes {shares['planes'] / wall:.1%} ({card})")
    log(f"  cluster on the first {SUBSET}: cuda {sub_cuda[0]:.3f} s, cpu "
        f"{sub_cpu[0]:.3f} s, .csv.xz and .aln.xz byte-equal")
    phase_product(dev, idx)
    return sum(launches)


def phase_product(dev, idx) -> None:
    """cluster's distance product (torch._int_mm, a library call: the
    JAX package's XLA dot_general, no Pallas kernel) at the main path's
    shape, a pool of CLUSTER_POOL rows against the medoid store the
    FASTA run ended with: its time, its int8 bound, the feature planes'
    time; and its distances on a corner of the store equal to the CPU's."""
    from uvaia_tpu_torch.engine import cluster as cl
    n = idx.n
    rows, meds = idx._codes[:CLUSTER_POOL], idx._codes[:n]
    pb = idx.planes(rows, CLUSTER_POOL)
    pm = idx.planes(meds, -n % 8 + n, signed=True)
    M, K = pb.shape
    N = pm.shape[0]
    ms = timed_ms(lambda: cl.int8_product(pb, pm))
    bnd = bound(M * K + N * K + 4 * M * N, int8_ops=2.0 * M * N * K)
    planes_ms = timed_ms(lambda: idx.planes(meds, N, signed=True))
    planes_bnd = bound(n * L_SITES + N * K)
    cpu = cl.MedoidIndex(idx.L, idx.capacity, idx.trim, device="cpu")
    want = cpu.dists(rows[:24].cpu(), meds[:64].cpu())
    if not torch.equal(idx.dists(rows[:24], meds[:64]).cpu(), want):
        raise AssertionError("cluster distances on the card differ from "
                             "the CPU's")
    log(f"  distance product (torch._int_mm) M={M} N={N} K={K}: {ms:.3f} "
        f"ms, {2.0 * M * N * K / ms / 1e9:,.1f} TOP/s, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); the medoid planes "
        f"{planes_ms:.3f} ms (bound {planes_bnd['bound_ms']:.4f} ms, "
        f"bytes); 24 x 64 distances equal to the CPU's")


# ----------------------------------------------------------------------
# align: synthetic unaligned genomes (letters)


def mutate(rng, ref: bytes, snps: int = 0, n_run: int = 0,
           indels: int = 0, max_indel: int = 30) -> bytes:
    """`ref` with `snps` random bases, one run of `n_run` Ns and
    `indels` insertions or deletions of 1..max_indel bases."""
    q = bytearray(ref)
    for p in rng.integers(0, len(q), snps):
        q[p] = ACGT[rng.integers(0, 4)]
    if n_run:
        s = int(rng.integers(0, len(q) - n_run))
        q[s:s + n_run] = b"N" * n_run
    for _ in range(indels):
        p = int(rng.integers(0, len(q) - max_indel))
        ln = int(rng.integers(1, max_indel + 1))
        if rng.random() < 0.5:
            del q[p:p + ln]
        else:
            q[p:p] = ACGT[rng.integers(0, 4, ln)].tobytes()
    return bytes(q)


def write_records(path: Path, recs) -> None:
    with open(path, "wb") as f:
        f.write(b"".join(b">%s\n%s\n" % (name.encode(), seq)
                         for name, seq in recs))


def read_xz_records(path: Path) -> list[bytes]:
    """The records of a FASTA .xz file, each '>name\nseq\n' as bytes."""
    text = lzma.decompress(path.read_bytes())
    return [b">" + r for r in text.split(b">")[1:]]


def oracle_score(ref: bytes, q: bytes) -> int:
    """Optimal global affine-gap cost (match 0, mismatch 4, gap 6+2g),
    dense O(nm): tests/test_gotoh.py:oracle_score on Python lists."""
    X, O, E, BIG = 4, 6, 2, 10**9
    n, m = len(ref), len(q)
    M = [[BIG] * (m + 1) for _ in range(n + 1)]
    Dx = [[BIG] * (m + 1) for _ in range(n + 1)]  # gap consuming ref
    Iy = [[BIG] * (m + 1) for _ in range(n + 1)]  # gap consuming query
    M[0][0] = 0
    for j in range(1, m + 1):
        Iy[0][j] = O + E * j
    for i in range(1, n + 1):
        Dx[i][0] = O + E * i
    H = lambda i, j: min(M[i][j], Dx[i][j], Iy[i][j])
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = 0 if ref[i - 1] == q[j - 1] else X
            M[i][j] = H(i - 1, j - 1) + sub
            Dx[i][j] = min(H(i - 1, j) + O + E, Dx[i - 1][j] + E)
            Iy[i][j] = min(H(i, j - 1) + O + E, Iy[i][j - 1] + E)
    return H(n, m)


def gotoh_batch(rng, ref: bytes, B: int, m_pad: int):
    """(q (B, m_pad), qlen (B,)) of mutants of `ref`: 30 SNPs, 1-3
    indels of 1-30 bases, a 200-300-base N run on every third row."""
    arr = np.zeros((B, m_pad), np.uint8)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        q = mutate(rng, ref, snps=30, indels=int(rng.integers(1, 4)),
                   n_run=int(rng.integers(200, 301)) if b % 3 == 0 else 0)
        arr[b, :len(q)] = np.frombuffer(q, np.uint8)
        lens[b] = len(q)
    return arr, lens


def timed_once(fn):
    """(fn(), milliseconds) from CUDA events around one call."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


GOTOH_SHORT_N = 2000   # reference bases the added shapes are checked on


def phase_gotoh(dev, rng, records: dict) -> None:
    """Both banded Gotoh kernels vs their plain versions on the same
    tensors, exact at every tb cell, score, t_end and edge.  At the full
    reference length: B=64 at the first band level (lo, W) = (-64, 129)
    and B=4 at W=4097.  Timed at the full length but checked on the
    first GOTOH_SHORT_N reference bases (the plain version is a Python
    loop of ~30 launches a row): B=256 at W=129, and the widest band one
    warp takes and the next one up (a CTA of several warps).  Kernel
    times are medians over repeated launches, the plain versions' one
    call each."""
    ref = ACGT[rng.integers(0, 4, N_REF)].tobytes()
    ref_d = torch.from_numpy(np.frombuffer(ref, np.uint8).copy()).to(dev)
    ref_short = ref_d[:GOTOH_SHORT_N].contiguous()
    edge_w = gotoh_kernels.WARP_MAX_WIDTH
    for B, W, full in ((64, 129, True), (4, 4097, True), (256, 129, False),
                       (64, edge_w, False), (64, edge_w + 1, False)):
        lo = -(W // 2)
        arr, lens = gotoh_batch(rng, ref, B, N_REF + 256)
        q_d = torch.from_numpy(arr).to(dev)
        ql_d = torch.from_numpy(lens).to(dev)
        args = (ref_d, q_d, ql_d, lo, W)
        # the rows of the short check end inside the short reference's band
        held = args if full else (
            ref_short, q_d[:, :GOTOH_SHORT_N + 256].contiguous(),
            torch.clamp(ql_d, max=GOTOH_SHORT_N + 40), lo, W)
        for name, fn, plain in (
                ("gotoh_forward", gotoh_kernels.gotoh_forward,
                 gotoh_kernels.gotoh_forward_plain),
                ("gotoh_score", gotoh_kernels.gotoh_score,
                 gotoh_kernels.gotoh_score_plain)):
            want, plain_ms = timed_once(lambda: plain(*held))
            err = max_err(fn(*held), want)
            del want
            ms = timed_ms(lambda: fn(*args), reps=3)
            cells = B * N_REF * W
            bnd = bound(ref_d.numel() + q_d.numel() + 4 * B + 12 * B
                        + (cells if name == "gotoh_forward" else 0),
                        int32_ops=GOTOH_CELL_OPS[name] * cells,
                        chain_ops=gotoh_chain_ops(N_REF, W))
            plan = gotoh_kernels.forward_plan(W)
            shape = f"B={B} n={N_REF} lo={lo} W={W}"
            log(f"  {name} {shape} (slots, warps)={plan}: max_abs_err={err}"
                f" on n={held[0].shape[0]}, kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms (n={held[0].shape[0]}), library none, "
                f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; bytes "
                f"{bnd['bytes_ms']:.4f}, operations "
                f"{bnd['operations_ms']:.4f}, chain {bnd['chain_ms']:.4f})")
            rec = dict(shape=shape, checked_n=held[0].shape[0],
                       max_abs_err=err, ms=ms, kernel_ms=ms,
                       plain_ms=plain_ms, library_ms=None, **bnd)
            if (B, W) == (64, 129):
                records[name].update(rec)
            else:
                records[name].setdefault("other_shapes", []).append(rec)
        del q_d, held, args
        torch.cuda.empty_cache()


def phase_align_oracle(dev, rng) -> int:
    """align_batch (forward kernel + event traceback + host decode) and
    the score-only kernel on the card against the O(nm) oracle; returns
    gotoh_score's launches over this phase."""
    n, B, lo, W = 400, 16, -64, 129
    ref = ACGT[rng.integers(0, 4, n)].tobytes()
    qs = [mutate(rng, ref, snps=int(rng.integers(0, 10)),
                 indels=int(rng.integers(0, 3)), max_indel=12)
          for _ in range(B)]
    arr = np.zeros((B, max(map(len, qs))), np.uint8)
    for b, q in enumerate(qs):
        arr[b, :len(q)] = np.frombuffer(q, np.uint8)
    lens = np.array([len(q) for q in qs], np.int32)
    want = np.array([oracle_score(ref, q) for q in qs])
    gotoh_kernels.gotoh_score.launches = 0
    ref_a = np.frombuffer(ref, np.uint8)
    aligned, score, ok, _, _ = gotoh.align_batch(ref_a, arr, lens, lo, W,
                                                 device=dev)
    score2, _ = gotoh_kernels.gotoh_score(
        *(torch.from_numpy(x).to(dev) for x in (ref_a.copy(), arr, lens)),
        lo, W)
    launches = gotoh_kernels.gotoh_score.launches
    if not ok.all():
        raise AssertionError(f"align_batch rows not ok: {np.nonzero(~ok)}")
    if not (np.array_equal(score, want)
            and np.array_equal(score2.cpu().numpy(), want)):
        raise AssertionError(f"scores {score} / {score2} != oracle {want}")
    if aligned.shape != (B, n):
        raise AssertionError(f"aligned rows {aligned.shape} != {(B, n)}")
    log(f"  align_batch and gotoh_score vs oracle: n={n} B={B} W={W}: "
        f"{B} scores equal (max {want.max()}), every row ok")
    return launches


def align_queries(rng, ref: bytes, count: int):
    """(name, seq) records: ~30 SNPs each and 1-30-base indels on ~30%;
    from record 64 on also a 200-300-base N run on every fourth and
    truncated or extended ends (up to 300 bases) on ~5%.  The first 64
    stay at the first band level, so the `--device cpu` run of them is
    one (B=64, W=129) forward.  Records 100-103 take the remaining
    branches: a too-short and a too-ambiguous one (QC), one with 110
    one-base deletions (more than EV_CAP/2 gap runs: the dense walk)
    and one whose 150-base insertion is cancelled by a 150-base
    deletion (net offset 0, but the path escapes the first bands)."""
    n = len(ref)
    recs = []
    for k in range(count):
        q = mutate(rng, ref, snps=30,
                   n_run=int(rng.integers(200, 301))
                   if k >= 64 and k % 4 == 0 else 0,
                   indels=int(rng.random() < 0.3) * int(rng.integers(1, 3)))
        if k >= 64 and rng.random() < 0.05:
            cut = int(rng.integers(1, 301))
            q = (q[cut:] if rng.random() < 0.5
                 else q + ACGT[rng.integers(0, 4, cut)].tobytes())
        recs.append((f"q{k}", q))
    recs[100] = ("short", ref[: n // 2])
    recs[101] = ("ambiguous", b"N" * (6 * n // 10) + ref[6 * n // 10:])
    gapped = bytearray(ref)
    for p in range(n - 200, 100, -(n - 300) // 110)[:110]:
        del gapped[p]
    recs[102] = ("gapped", bytes(gapped))
    ins = ACGT[rng.integers(0, 4, 150)].tobytes()
    a, b = 3 * n // 10, 2 * n // 3
    recs[103] = ("wander", ref[:a] + ins + ref[a:b] + ref[b + 150:])
    return recs


def phase_align_scale(dev, card: str, work: dict) -> int:
    """`align` through the command line at scale on the card; returns
    gotoh_forward's launches over the run."""
    pool = 1024
    ref, q_fa, n_q = work["ref"], work["q_fa"], work["count"]
    calls = {"dense": 0, "escalate": 0, "cap_band": 0}

    def counting(fn, key, when=lambda *a, **kw: True):
        def wrapped(*a, **kw):
            if when(*a, **kw):
                calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    orig = (gotoh.align_rows_dense, align._align_group, align._choose_band)
    gotoh.align_rows_dense = counting(orig[0], "dense")
    align._align_group = counting(orig[1], "escalate",
                                  lambda *a, exact=False, **kw: not exact)
    align._choose_band = counting(orig[2], "cap_band")
    stats_holder = {}
    run = align.run_align

    def keep_stats(*a, **kw):
        stats_holder["s"] = run(*a, **kw)
        return stats_holder["s"]

    align.run_align = keep_stats
    out = WORK / "al_cuda"
    try:
        gotoh_kernels.gotoh_forward.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli_main(["align", "-r", str(WORK / "al_ref.fa"), str(q_fa),
                       "-p", str(pool), "-o", str(out), "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gotoh_kernels.gotoh_forward.launches
    finally:
        (gotoh.align_rows_dense, align._align_group,
         align._choose_band) = orig
        align.run_align = run
    if rc != 0:
        raise AssertionError(f"align exited {rc}")
    st = stats_holder["s"]
    log(f"  align: {n_q} queries x {len(ref)} bp, pool={pool}: {wall:.3f} s "
        f"wall, {n_q / wall:,.1f} seqs/s ({card})")
    log(f"  AlignStats: count={st.count} n_output={st.n_output} "
        f"rejected_length={st.rejected_length} rejected_ambiguity="
        f"{st.rejected_ambiguity} failed_band={st.failed_band} uncertified="
        f"{st.uncertified} exact_certified={st.exact_certified}; dense "
        f"walks {calls['dense']}, escalations {calls['escalate']}, "
        f"cap-band groups {calls['cap_band']}; gotoh_forward launches "
        f"{launches}")
    recs = work["cuda_recs"] = read_xz_records(
        out.parent / (out.name + ".aln.xz"))
    if len(recs) != st.n_output or st.n_output != st.count - 2:
        raise AssertionError(f"{len(recs)} rows written, stats {st}")
    if any(len(r.split(b"\n")[1]) != len(ref) for r in recs):
        raise AssertionError("an emitted row does not have the reference "
                             "length")
    if st.uncertified or st.failed_band:
        raise AssertionError(f"uncertified or failed rows: {st}")
    if not (st.rejected_length and st.rejected_ambiguity
            and all(calls.values())):
        raise AssertionError(f"a branch was not taken: {st} {calls}")
    if launches == 0:
        raise AssertionError("gotoh_forward never launched in the run")
    return launches


def start_cpu_subset(rng, n_ref: int = N_REF, count: int = 2048) -> dict:
    """Write phase 7's files (`count` queries against an `n_ref`-bp
    reference) and start the port's `--device cpu` run on the first 64
    QC-passing queries in a child process on one thread (its plain
    row loop is launch-bound; more threads only slow the host-bound
    phases it overlaps), so it runs while phases 2-7 use the card."""
    ref = ACGT[rng.integers(0, 4, n_ref)].tobytes()
    recs = align_queries(rng, ref, count)
    write_records(WORK / "al_ref.fa", [("ref", ref)])
    q_fa = WORK / "al_q.fa"
    write_records(q_fa, recs)
    write_records(WORK / "al_q64.fa", recs[:64])
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "uvaia_tpu_torch", "align", "-r",
           str(WORK / "al_ref.fa"), str(WORK / "al_q64.fa"), "-o",
           str(WORK / "al_cpu"), "--device", "cpu"]
    with open(WORK / "al_cpu.log", "wb") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.DEVNULL, stderr=err)
    return dict(ref=ref, q_fa=q_fa, count=count, proc=proc,
                t0=time.perf_counter())


def finish_cpu_subset(work: dict) -> None:
    """Wait for the `--device cpu` child and compare its rows with the
    card's first 64."""
    rc = work["proc"].wait()
    wall = time.perf_counter() - work["t0"]
    if rc != 0:
        raise AssertionError(f"align --device cpu exited {rc}: "
                             + (WORK / "al_cpu.log").read_text()[-2000:])
    cpu = read_xz_records(WORK / "al_cpu.aln.xz")
    if len(cpu) != 64 or cpu != work["cuda_recs"][:64]:
        raise AssertionError(f"--device cpu rows ({len(cpu)}) differ from "
                             "the card's first 64")
    log(f"  the first 64 rows are byte-equal under --device cuda and "
        f"--device cpu (child process, {wall:.3f} s from its start)")



# ----------------------------------------------------------------------
# the mesh and several processes


MESH_KERNELS = ("delta_rebuild", "score_counters", "amb_corr",
                "acgt_counters")
MESH_SHAPES = ((4, 1), (2, 2), (1, 4))


class LaunchTally:
    """Launches of MESH_KERNELS made inside `counted` calls only."""

    def __init__(self):
        self.counts = dict.fromkeys(MESH_KERNELS, 0)

    def counted(self, fn, *args):
        before = {n: KERNELS[n]["wrapper"].launches for n in MESH_KERNELS}
        out = fn(*args)
        for n in MESH_KERNELS:
            self.counts[n] += KERNELS[n]["wrapper"].launches - before[n]
        return out


@contextlib.contextmanager
def one_card_mesh():
    """Inside the block every shard of a mesh names cuda:0 (the card is
    one), where the mesh would take cuda:0 .. cuda:n-1."""
    from uvaia_tpu_torch.parallel import mesh as pmesh
    orig = pmesh.local_devices
    pmesh.local_devices = lambda kind, n: [torch.device("cuda", 0)] * n
    try:
        yield
    finally:
        pmesh.local_devices = orig


def mesh_batches(dev, n_batches: int, codes: np.ndarray, base):
    """Phase 4's genomes as the step payloads: even batches as sparse
    deltas, odd ones packed (batch 3 holds phase 4's far row, which no
    delta bucket takes)."""
    out = []
    ok = np.ones(BATCH, dtype=bool)
    for i in range(n_batches):
        c = codes[i * BATCH:(i + 1) * BATCH]
        enc = host.delta_encode(c, ok, base) if i % 2 == 0 else None
        if i % 2 == 0 and enc is None:
            raise AssertionError(f"mesh batch {i} did not fit the delta "
                                 "buckets")
        payload = (("delta", *(torch.from_numpy(x).to(dev) for x in enc))
                   if enc is not None else
                   ("packed", torch.from_numpy(host.pack_codes(c)).to(dev)))
        ridx = torch.arange(i * BATCH, (i + 1) * BATCH, dtype=torch.int32,
                            device=dev)
        out.append((payload, ridx))
    return out


def mesh_steps(dev, card: str, tally: LaunchTally, n_batches: int,
               k: int) -> dict:
    """The sharded step and the survivor path at each MESH_SHAPES shape,
    full mode and --acgt, on phase 4's genomes: state and is_best
    bit-equal to the one-device steps at every batch, and the survivor
    path's final state to the dense one; then a step timed at each shape
    beside the one-device step.  Returns {label: ms}."""
    from uvaia_tpu_torch.parallel import mesh as pmesh
    codes = LUT[read_letters(WORK / "s_db.fa", n_batches * BATCH)]
    ok_d = torch.ones(BATCH, dtype=torch.bool, device=dev)
    times = {}
    for acgt in (False, True):
        pack = build_query_pack(str(WORK / "s_q.fa"), acgt=acgt)
        qd_1 = scan.build_device_data(pack, k=k, device=dev)
        batches = mesh_batches(dev, n_batches, codes,
                               qd_1.delta_base.cpu().numpy())
        mode = " --acgt" if acgt else ""
        for n_db, n_site in MESH_SHAPES:
            mesh = pmesh.make_mesh(n_db, n_site)
            qd = scan.build_device_data(pack, k=k, device=dev,
                                        site_shards=n_site)
            scan.build_prune_data(qd, pack)
            if not acgt and qd.amb_sites is None:
                raise AssertionError("the mesh queries have no ambiguity "
                                     "columns")
            step = {"delta": pmesh.make_sharded_scan_step(qd, mesh, True),
                    "packed": pmesh.make_sharded_scan_step(qd, mesh)}
            one = {"delta": scan.scan_step_delta,
                   "packed": scan.scan_step_packed}
            cap = 2 * (BATCH // n_db)
            init, acc, acc_d, flush = pmesh.make_sharded_survivor_ops(
                qd, mesh, cap)
            bufs = init()
            st_s = scan.init_state(pack.n_query, k, device=dev)
            st_1 = scan.init_state(pack.n_query, k, device=dev)
            st_v = scan.init_state(pack.n_query, k, device=dev)
            for i, ((kind, *pl), ridx) in enumerate(batches):
                st_s, fl_s = tally.counted(step[kind], st_s, *pl, ok_d, ridx)
                st_1, fl_1 = one[kind](qd_1, st_1, *pl, ok_d, i * BATCH)
                a = acc_d if kind == "delta" else acc
                _, bufs = tally.counted(a, st_v, bufs, *pl, ok_d, ridx)
                if not (torch.equal(fl_s, fl_1) and torch.equal(st_s[0],
                        st_1[0]) and torch.equal(st_s[1], st_1[1])):
                    raise AssertionError(f"mesh {n_db}x{n_site}{mode}: the "
                                         f"sharded {kind} step differs at "
                                         f"batch {i}")
                if int(bufs.fill().max()) + BATCH // n_db > cap:
                    st_v, _, bufs = tally.counted(flush, st_v, bufs)
            st_v, _, bufs = tally.counted(flush, st_v, bufs)
            if not (torch.equal(st_v[0], st_1[0])
                    and torch.equal(st_v[1], st_1[1])):
                raise AssertionError(f"mesh {n_db}x{n_site}{mode}: the "
                                     "survivor path's state differs")
            pos, val = batches[0][0][1:]
            base = [n_batches * BATCH]

            def sharded():
                base[0] += BATCH
                ridx = torch.arange(base[0], base[0] + BATCH,
                                    dtype=torch.int32, device=dev)
                holder[0], _ = step["delta"](holder[0], pos, val, ok_d,
                                             ridx)
            holder = [st_s]
            ms = timed_ms(sharded, reps=5)
            times[f"{n_db}x{n_site}{mode}"] = ms
            log(f"  mesh {n_db}x{n_site}{mode}: {n_batches} batches "
                f"(delta, packed) bit-equal to the one-device steps, "
                f"survivor path equal to the dense state; sharded delta "
                f"step {ms:.3f} ms (L={L_SITES}, Q={pack.n_query}, "
                f"B={BATCH}, k={k}; the shards share one card and run one "
                f"after another: the mesh's overhead, not a speed-up) "
                f"({card})")
        holder = [st_1]

        def single():
            base[0] += BATCH
            holder[0], _ = scan.scan_step_delta(qd_1, holder[0], pos, val,
                                                ok_d, base[0])
        ms = timed_ms(single, reps=5)
        times[f"one device{mode}"] = ms
        log(f"  one-device scan_step_delta{mode} on the same batch: "
            f"{ms:.3f} ms ({card})")
    return times


def run_multihost_cli(dev, argv: list, n: int = 2, timeout: int = 300):
    """`nearest ... --num-hosts n` as n child processes on the card, a
    gloo rendezvous on a free localhost port; returns the wall time."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "uvaia_tpu_torch", *argv, "--device",
           str(dev), "--num-hosts", str(n), "--coordinator",
           f"localhost:{port}"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--host-id", str(i)], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"--num-hosts {n}: process {i} exited "
                                 f"{p.returncode}:\n{o[-3000:]}")
    return wall


def split_fasta(src: Path, first: Path, rest: Path, n_first: int) -> None:
    """A one-line-a-record FASTA file as two: its first n_first records,
    then the others."""
    with open(src, "rb") as f, open(first, "wb") as a, open(rest, "wb") as b:
        for i, line in enumerate(f):
            (a if i < 2 * n_first else b).write(line)


def phase_mesh(dev, card: str, n: int) -> dict:
    """Phase 11: the mesh step by step, `nearest --devices 4
    --site-shards 2` end to end, and `nearest --num-hosts 2` from the
    store and from two FASTA files; returns the launches of MESH_KERNELS
    made by the sharded path (counted around its calls)."""
    tally = LaunchTally()
    want = (WORK / "s_prune.csv.xz").read_bytes()
    out = WORK / "m_mesh"
    with one_card_mesh():
        with score_kernels.full_float32_matmuls():
            mesh_steps(dev, card, tally, 4, 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tally.counted(run_nearest, [str(WORK / "s_db.fa")],
                      str(WORK / "s_q.fa"),
                      NearestConfig(nbest=100, pool=BATCH, output=str(out),
                                    n_devices=4, site_shards=2,
                                    device=str(dev)))
        wall = time.perf_counter() - t0
    if (WORK / "m_mesh.csv.xz").read_bytes() != want:
        raise AssertionError("nearest --devices 4 --site-shards 2: the CSV "
                             "differs from phase 4's")
    log(f"  nearest --devices 4 --site-shards 2 (one card, 2x2 shards): "
        f"{n} genomes, Q=64, nbest=100, pool={BATCH}, prune on: "
        f"{wall:.3f} s wall, {n / wall:,.1f} genomes/s; CSV byte-equal to "
        f"phase 4's ({card})")
    common = [str(WORK / "s_q.fa"), "-n", "100", "-p", str(BATCH)]
    wall = run_multihost_cli(dev, ["nearest", "-r", str(WORK / "s_db.uvst"),
                                   *common, "-o", str(WORK / "m_hosts_st")])
    if (WORK / "m_hosts_st.csv.xz").read_bytes() != want:
        raise AssertionError("nearest --num-hosts 2 from the store: the "
                             "merged CSV differs from the one-process CSV")
    log(f"  nearest --num-hosts 2, phase 10's store split by rows (two "
        f"processes on one card): {wall:.3f} s wall from the start of both, "
        f"merged CSV byte-equal to the one-process CSV ({card})")
    a, b = WORK / "m_db_a.fa", WORK / "m_db_b.fa"
    split_fasta(WORK / "s_db.fa", a, b, n // 2)
    wall = run_multihost_cli(dev, ["nearest", "-r", str(a), "-r", str(b),
                                   *common, "-o", str(WORK / "m_hosts_fa")])
    if (WORK / "m_hosts_fa.csv.xz").read_bytes() != want:
        raise AssertionError("nearest --num-hosts 2 on two FASTA files: "
                             "the merged CSV differs from the one-process "
                             "CSV")
    log(f"  nearest --num-hosts 2, phase 4's genomes as two FASTA files "
        f"split by files: {wall:.3f} s wall from the start of both, merged "
        f"CSV byte-equal to the one-process CSV ({card})")
    missing = [k for k, v in tally.counts.items() if v == 0]
    log(f"  launches of the sharded path over phase 11: {tally.counts}")
    if missing:
        raise AssertionError(f"kernels never launched on the sharded "
                             f"path: {missing}")
    return tally.counts


def run(dev: torch.device, card: str) -> dict:
    """Phases 1-11 on `dev`; returns the kernels' JSON records."""
    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(2024)
    records = {name: dict(name=name, route="cuda", source=w["source"],
                          replaces=w["replaces"])
               for name, w in KERNELS.items()}
    work = None
    t_start = time.perf_counter()

    def lap(name: str) -> None:
        log(f"  {name} done at {time.perf_counter() - t_start:.1f} s")

    try:
        log("phase 1: build")
        t0 = time.perf_counter()
        _build.build(verbose=True)
        _build.lib()
        log(f"  built {_build.LIB_PATH.name} from "
            f"{len(_build._sources())} sources in "
            f"{time.perf_counter() - t0:.3f} s")
        work = start_cpu_subset(np.random.default_rng(7))
        log("phase 2: kernels vs plain versions")
        phase_kernels(dev, rng, BATCH, L_SITES, (64, 1000, 7, 129), records)
        lap("nearest kernels")
        phase_gotoh(dev, rng, records)
        lap("previous phase")
        log("phase 3: nearest vs oracle, full mode and --acgt")
        phase_oracle(dev, rng, L_SITES)
        lap("previous phase")
        log("phase 4: nearest at scale, prune on and off, full mode and "
            "--acgt")
        counts = phase_scale(dev, rng, 16384, L_SITES, 64, 100, BATCH)
        for name, c in counts.items():
            records[name]["launches"] = c
        lap("previous phase")
        log("phase 5: device-resident step rate, full mode and --acgt")
        phase_steps(dev, rng, L_SITES, 64, BATCH, 50, 20, card)
        lap("previous phase")
        log("phase 6: align_batch and gotoh_score vs oracle")
        records["gotoh_score"]["launches"] = phase_align_oracle(dev, rng)
        lap("previous phase")
        log("phase 7: align at scale, cuda vs cpu")
        records["gotoh_forward"]["launches"] = phase_align_scale(
            dev, card, work)
        finish_cpu_subset(work)
        lap("phase 7")
        log("phase 8: ball at scale, cuda vs cpu vs the numpy keep rule")
        records["delta_rebuild"]["launches"] += phase_ball(
            dev, 16384, BATCH, BALL_RADIUS)
        lap("phase 8")
        log("phase 9: legacy, cuda vs cpu vs the numpy oracle")
        phase_legacy(dev)
        lap("phase 9")
        log("phase 10: ingest, info --verify, nearest from the store, "
            "cluster at scale and cuda vs cpu")
        phase_store(dev, card, 16384)
        records["delta_rebuild"]["launches"] += phase_cluster(dev, card,
                                                              16384)
        lap("phase 10")
        log("phase 11: the mesh step by step, nearest --devices 4 "
            "--site-shards 2, nearest --num-hosts 2")
        for name, c in phase_mesh(dev, card, 16384).items():
            records[name]["launches"] += c
        lap("phase 11")
    finally:
        if work is not None and work["proc"].poll() is None:
            work["proc"].kill()
            work["proc"].wait()
        shutil.rmtree(WORK, ignore_errors=True)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    more = ("other_shapes", "device_ms", "library_device_ms")
    return {"kernels": [{**{k: r[k] for k in keys},
                         **{k: r[k] for k in more if k in r}}
                        for r in records.values()]}


def main() -> int:
    log("phase 0: environment")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            and smi.stdout.strip() else "nvidia-smi unavailable"
    except (OSError, subprocess.TimeoutExpired):
        card = "nvidia-smi unavailable"
    log(f"  card: {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        log("  torch.cuda.is_available() is False: this smoke test needs "
            "a CUDA GPU")
        return 1
    lib = native.get_lib()
    if lib is None:
        log("  the port's native IO library did not build or load")
        return 1
    log(f"  native IO library loaded: {native.LIB_PATH.name}, codecs: raw "
        f"+ {native.codecs(lib)} (bz2 and the others through Python)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = run(dev, card)
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
