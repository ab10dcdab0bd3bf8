"""Where `cluster` spends its time on the GPU (uvaia_tpu_torch).

    python scripts/profile_cluster_torch.py [--genomes 16384] [-d 38]

Generates data shaped as chip_smoke.py's phase 4 (synthetic
SARS-CoV-2-length genomes around 64 parents, fixed seed, one far row),
ingests it into a store with the port, then runs the port's
`run_cluster` on the card, pool 1024, from the FASTA and from the store:
  1. plain: wall time and genomes/s;
  2. with host timers: the reader alone on the same input (FASTA:
     RefStreamer; store: StoreStreamer), `MedoidIndex.assign` and
     `apply_updates` (synchronised), the medoid sequences taken from the
     batches (`seq`: a row copy from FASTA, a decode from the store), the
     final merge and the `.aln` writer; the rest is the per-row loop of
     `process`, the streamer and the membership CSV;
  3. under torch.profiler (CUDA activity): device busy time against the
     wall time, and device time by kernel;
  4. under cProfile: the host functions with the most own time.
Prints one JSON object per run, each with the card's name and power
limit as nvidia-smi gives them; needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from uvaia_tpu_torch.engine import cluster as cl  # noqa: E402
from uvaia_tpu_torch.engine import stream  # noqa: E402
from uvaia_tpu_torch.io import store as store_mod  # noqa: E402
from uvaia_tpu_torch.ops import _build  # noqa: E402

WORK = ROOT / "build" / "profile_cluster"
POOL = 1024


def timed(fn, acc: dict, key: str, sync: bool = False):
    def wrapped(*a, **kw):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return out
    return wrapped


def run_once(src: Path, dist: int, out: str):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    merged = cl.run_cluster([str(src)], cl.ClusterConfig(
        distance=dist, pool=POOL, output=str(WORK / out), device="cuda"))
    torch.cuda.synchronize()
    return merged, time.perf_counter() - t0


def reader_alone(src: Path, L: int) -> float:
    t0 = time.perf_counter()
    if store_mod.is_store(src):
        for _ in store_mod.StoreStreamer([str(src)], L, POOL,
                                         ref_ambiguity=1.0):
            pass
    else:
        for _ in stream.RefStreamer([str(src)], L, POOL, ref_ambiguity=1.0):
            pass
    return time.perf_counter() - t0


def with_timers(src: Path, dist: int, out: str) -> dict:
    acc: dict[str, float] = {}
    idx_cls = cl.MedoidIndex
    saved = (idx_cls.assign, idx_cls.apply_updates, cl._merge_clusters,
             cl.make_fasta_writer, stream.RefBatch.seq,
             store_mod.StoreBatch.seq)
    idx_cls.assign = timed(saved[0], acc, "assign", True)
    idx_cls.apply_updates = timed(saved[1], acc, "apply_updates", True)
    cl._merge_clusters = timed(saved[2], acc, "merge", True)
    stream.RefBatch.seq = timed(saved[4], acc, "batch_seq")
    store_mod.StoreBatch.seq = timed(saved[5], acc, "batch_seq")

    def writer(*a, **kw):
        w = saved[3](*a, **kw)
        w.write = timed(w.write, acc, "aln_writer")
        w.close = timed(w.close, acc, "aln_writer")
        return w

    cl.make_fasta_writer = writer
    try:
        _, wall = run_once(src, dist, out)
    finally:
        (idx_cls.assign, idx_cls.apply_updates, cl._merge_clusters,
         cl.make_fasta_writer, stream.RefBatch.seq,
         store_mod.StoreBatch.seq) = saved
    acc["rest"] = wall - sum(acc.values())
    return {"wall_s": wall, **{k: round(v, 6) for k, v in acc.items()}}


def profiled(src: Path, dist: int, out: str) -> dict:
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = run_once(src, dist, out)
    by_kernel: dict[str, list] = {}
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            rec = by_kernel.setdefault(ev.name()[:60], [0.0, 0])
            rec[0] += ev.duration_ns() / 1e9
            rec[1] += 1
    busy = sum(v[0] for v in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall,
            "device_ops": sum(v[1] for v in by_kernel.values()),
            "top_device_s_count": top}


def host_profile(src: Path, dist: int, out: str) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    _, wall = run_once(src, dist, out)
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
    return {"wall_s": wall, "top_own_s": [
        [f"{Path(f).name}:{line} {fn}", round(v[2], 4), v[1]]
        for (f, line, fn), v in rows]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genomes", type=int, default=16384)
    ap.add_argument("-d", "--distance", type=int,
                    default=chip_smoke.CLUSTER_DISTANCE)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    n, L = args.genomes, chip_smoke.L_SITES
    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(2024)
    queries = chip_smoke.query_set(rng, L, 64)
    refs = chip_smoke.make_genomes(rng, n, L, queries, snps=25, amb=3,
                                   n_runs=2)
    far = refs[n - 2048]            # more diffs than any delta bucket
    far[rng.permutation(L)[:3 * L // 10]] = chip_smoke.ACGT[
        rng.integers(0, 4, 3 * L // 10)]
    db_fa, st_dir = WORK / "db.fa", WORK / "db.uvst"
    chip_smoke.write_fasta(db_fa, "r", refs)
    del refs
    dev = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() \
        or torch.cuda.get_device_name(0)
    try:
        _build.lib()                                # builds the kernels
        t0 = time.perf_counter()
        store_mod.ingest([str(db_fa)], str(st_dir), block=4096)
        print(json.dumps({"run": "ingest", "device": dev,
                          "wall_s": time.perf_counter() - t0}), flush=True)
        for src, tag in ((db_fa, "fasta"), (st_dir, "store")):
            merged, wall = run_once(src, args.distance, f"{tag}_plain")
            print(json.dumps({"run": f"plain, {tag}", "device": dev,
                              "wall_s": wall, "genomes_per_s": n / wall,
                              "clusters": len(merged)}), flush=True)
            print(json.dumps({"run": f"timers, {tag}", "device": dev,
                              "reader_alone_s": reader_alone(src, L),
                              **with_timers(src, args.distance,
                                            f"{tag}_timers")}), flush=True)
            print(json.dumps({"run": f"profiled, {tag}", "device": dev,
                              **profiled(src, args.distance,
                                         f"{tag}_prof")}), flush=True)
            print(json.dumps({"run": f"cProfile, {tag}", "device": dev,
                              **host_profile(src, args.distance,
                                             f"{tag}_cprof")}), flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
