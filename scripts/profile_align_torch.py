"""Where `align` spends its time on the GPU (uvaia_tpu_torch).

    python scripts/profile_align_torch.py [--queries 2048]

Generates chip_smoke.py's phase-7 data (synthetic SARS-CoV-2-length
queries against a 29,903-bp reference, fixed seed), then runs the
port's `run_align` on the card four times, pool 1024:
  1. plain: wall time and seqs/s, then the same with the dense walk's
     iterations launched op by op instead of replayed from a CUDA graph
     (the events walk is one kernel, csrc/walk.cu, either way);
  2. with host timers around each stage: host read + QC (the reader's
     work, timed alone on the same file), the upload, the forward (the
     wrapper, synchronised), the events walk (flags and walk kernels)
     and the dense walk (with its loop iterations and host reads of the
     loop condition), host decode_events and the writer;
  3. under torch.profiler (CUDA activity): device busy time (kernels,
     copies, memsets) against the wall time, and device time by kernel
     (summed from the raw events: a run launches ~10^5-10^6 small ops,
     too many for key_averages).
Prints one JSON object per run, each with the card's name and power
limit as nvidia-smi gives them; needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
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
from uvaia_tpu_torch.engine import align  # noqa: E402
from uvaia_tpu_torch.io.fasta import read_fasta  # noqa: E402
from uvaia_tpu_torch.ops import _build, gotoh, gotoh_kernels  # noqa: E402

WORK = ROOT / "build" / "profile_align"


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


def run_once(ref_fa: Path, q_fa: Path, out: str):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = align.run_align(str(ref_fa), [str(q_fa)], align.AlignConfig(
        pool=1024, output=str(WORK / out), device="cuda"))
    torch.cuda.synchronize()
    return stats, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--queries", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    WORK.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    ref = chip_smoke.ACGT[rng.integers(0, 4, chip_smoke.N_REF)].tobytes()
    ref_fa, q_fa = WORK / "ref.fa", WORK / "q.fa"
    chip_smoke.write_records(ref_fa, [("ref", ref)])
    chip_smoke.write_records(q_fa, chip_smoke.align_queries(
        rng, ref, args.queries))
    dev = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() \
        or torch.cuda.get_device_name(0)
    try:
        _build.lib()                                # builds the kernels
        stats, wall = run_once(ref_fa, q_fa, "plain")
        print(json.dumps({"run": "plain", "device": dev, "wall_s": wall,
                          "seqs_per_s": args.queries / wall,
                          "n_output": stats.n_output}), flush=True)
        capture = gotoh._capture_step
        gotoh._capture_step = lambda body, carry: None    # no graph: eager
        try:
            stats, wall = run_once(ref_fa, q_fa, "eager")
        finally:
            gotoh._capture_step = capture
        print(json.dumps({"run": "plain, dense walk launched op by op",
                          "device": dev, "wall_s": wall,
                          "seqs_per_s": args.queries / wall,
                          "n_output": stats.n_output}), flush=True)

        acc: dict[str, float] = {}
        t0 = time.perf_counter()
        st = align.AlignStats()
        for rec in read_fasta(str(q_fa)):
            align._qc(rec, len(ref), 0.5, st)
        acc["host_read_qc_alone"] = time.perf_counter() - t0
        orig = (gotoh_kernels.gotoh_forward, gotoh.gotoh_traceback_events,
                gotoh.decode_events, align.make_fasta_writer,
                gotoh.gotoh_traceback, align._make_device_batch)
        def forward(ref_d, q, qlen, lo, width):
            key = f"forward_W{width}"
            acc[key + "_rows"] = acc.get(key + "_rows", 0) + q.shape[0]
            return timed(orig[0], acc, key, True)(ref_d, q, qlen, lo, width)

        forward.launches = 0      # the kernel wrapper counts through its name
        gotoh_kernels.gotoh_forward = forward
        gotoh.gotoh_traceback_events = timed(orig[1], acc,
                                             "traceback_events", True)
        gotoh.decode_events = timed(orig[2], acc, "decode_events")
        gotoh.gotoh_traceback = timed(orig[4], acc, "dense_traceback", True)
        align._make_device_batch = timed(orig[5], acc, "upload", True)
        walks_before = dict(gotoh.walk_counts)

        def writer(*a, **kw):
            w = orig[3](*a, **kw)
            w.write = timed(w.write, acc, "writer")
            w.close = timed(w.close, acc, "writer")
            return w

        align.make_fasta_writer = writer
        try:
            _, wall = run_once(ref_fa, q_fa, "timers")
        finally:
            (gotoh_kernels.gotoh_forward, gotoh.gotoh_traceback_events,
             gotoh.decode_events, align.make_fasta_writer,
             gotoh.gotoh_traceback, align._make_device_batch) = orig
        acc["walk_iterations"] = (gotoh.walk_counts["iterations"]
                                  - walks_before["iterations"])
        acc["walk_host_reads"] = (gotoh.walk_counts["host_reads"]
                                  - walks_before["host_reads"])
        print(json.dumps({"run": "timers", "device": dev, "wall_s": wall,
                          **{k: round(v, 6) for k, v in acc.items()}}),
              flush=True)

        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, wall = run_once(ref_fa, q_fa, "prof")
        by_kernel: dict[str, list] = {}
        cuda = torch.autograd.DeviceType.CUDA
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == cuda:
                rec = by_kernel.setdefault(ev.name()[:60], [0.0, 0])
                rec[0] += ev.duration_ns() / 1e9
                rec[1] += 1
        busy = sum(v[0] for v in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
        print(json.dumps({"run": "profiled", "device": dev, "wall_s": wall,
                          "device_busy_s": busy,
                          "device_idle_share": 1 - busy / wall,
                          "device_ops": sum(v[1] for v in by_kernel.values()),
                          "top_device_s_count": top}), flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
