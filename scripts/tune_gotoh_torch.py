"""Check and time the banded Gotoh forward kernels on one NVIDIA GPU.

    python scripts/tune_gotoh_torch.py [check] [time] [corr]

Builds the kernel library (printing ptxas' registers and spills for
gotoh.cu and corr.cu), then
  * `check`: every variant of csrc/gotoh.cu (one warp a row, several
    warps a row, the wide kernel) against the plain PyTorch version at a
    short reference (n = 300), exact at every traceback cell, score,
    t_end and edge — forward_plan's own choice per width, and forced
    plans (slots, warps) at the same widths;
  * `time`: gotoh_forward and gotoh_score at n = 29,903 and the main
    path's shapes, CUDA-event medians, forward_plan's choice beside
    forced plans (a band given to one warp or to a CTA), so the
    crossover between the variants is a measurement;
  * `corr`: amb_corr against its plain version and timed at B = 4096,
    Q in {64, 1000}, A in {256, 12000}: a call between two CUDA events
    (host work included) and a launch inside a CUDA graph (device only).
Without arguments all three run.  Prints the card's name and power
limit with every time.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from uvaia_tpu_torch.ops import _build  # noqa: E402
from uvaia_tpu_torch.ops import gotoh_kernels as gk  # noqa: E402
from uvaia_tpu_torch.ops import score_kernels as sk  # noqa: E402

ACGT = np.frombuffer(b"ACGT", np.uint8)
N_REF = 29903


def timed(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed_graph(fn, calls: int = 20) -> float:
    """Device milliseconds a call: `calls` calls of fn captured in one
    CUDA graph (no host work between the launches), median replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return timed(graph.replay) / calls


def batch(rng, n: int, B: int, dev):
    """ref (n,), q (B, m_pad), qlen (B,): SNPs, an indel of up to 30
    bases, short and long ends, one empty row, zero padding."""
    ref = ACGT[rng.integers(0, 4, n)]
    qs = []
    for b in range(B):
        q = bytearray(ref.tobytes())
        for p in rng.integers(0, n, 8):
            q[int(p)] = ACGT[rng.integers(0, 4)]
        p, ln = int(rng.integers(0, n - 40)), int(rng.integers(1, 31))
        if b % 2:
            del q[p:p + ln]
        else:
            q[p:p] = ACGT[rng.integers(0, 4, ln)].tobytes()
        if b % 5 == 1:
            q = q[:len(q) - int(rng.integers(1, 60))]
        elif b % 5 == 3:
            q += ACGT[rng.integers(0, 4, int(rng.integers(1, 60)))].tobytes()
        elif b % 5 == 4 and b > 4:
            q = bytearray()
        qs.append(bytes(q))
    arr = np.zeros((B, max(map(len, qs)) + 29), np.uint8)
    for b, q in enumerate(qs):
        arr[b, :len(q)] = np.frombuffer(q, np.uint8)
    lens = np.array([len(q) for q in qs], np.int32)
    return [torch.from_numpy(x).to(dev) for x in (ref.copy(), arr, lens)]


def launch(args, lo, W, emit_tb, plan):
    tb, score, t_end, edge = gk._launch(*args, lo, W, emit_tb, plan=plan)
    return (tb, score, t_end, edge) if emit_tb else (score, edge)


CHECKS = [  # (W, forced plans beside forward_plan's own)
    (1, [(1, 2)]), (2, []), (31, []), (32, [(1, 8)]), (33, [(1, 2)]),
    (129, [(2, 3), (9, 1), (5, 2)]), (160, []), (161, [(1, 6)]),
    (257, [(3, 3), (17, 1)]), (513, [(4, 5), (17, 2)]), (544, [(17, 2)]),
    (545, [(17, 2)]), (1025, [(17, 2), (9, 4)]), (4097, []), (4352, []),
    (4353, []), (15361, [])]


def check(dev) -> None:
    rng = np.random.default_rng(11)
    for n, B in ((300, 13), (1, 3), (2, 1), (67, 64)):
        args = batch(rng, max(n, 64), B, dev)
        args[0] = args[0][:n].contiguous()
        for W, forced in CHECKS:
            if n != 300 and W > 600:
                continue
            lo = -(W // 2)
            want = gk.gotoh_forward_plain(*args, lo, W)
            want_s = (want[1], want[3])
            for plan in [None, *forced]:
                for emit, ref_out in ((True, want), (False, want_s)):
                    got = launch(args, lo, W, emit, plan)
                    torch.cuda.synchronize()
                    for g, w in zip(got, ref_out, strict=True):
                        if not torch.equal(g, w):
                            bad = (g != w).nonzero()[:4].tolist()
                            raise AssertionError(
                                f"n={n} B={B} W={W} plan={plan} "
                                f"emit_tb={emit}: differs at {bad}")
            print(f"check n={n} B={B} W={W} plans="
                  f"{[gk.forward_plan(W), *forced]}: exact", flush=True)


TIMES = [  # (B, W, plans; None = forward_plan's)
    (64, 129, [None, (5, 2), (2, 3), (9, 1)]),
    (256, 129, [None]),
    (64, 257, [None, (5, 2), (3, 3)]),
    (64, 513, [None, (9, 2), (5, 4), (3, 6)]),
    (64, 544, [None]), (64, 545, [None, (17, 2)]),
    (16, 1025, [None, (9, 4), (17, 2)]),
    (4, 4097, [None]), (4, 4353, [None])]


def time_all(dev, card: str) -> None:
    rng = np.random.default_rng(12)
    for B, W, plans in TIMES:
        args = batch(rng, N_REF, B, dev)
        lo = -(W // 2)
        for plan in plans:
            p = plan or gk.forward_plan(W)
            fwd = timed(lambda: launch(args, lo, W, True, plan))
            sc = timed(lambda: launch(args, lo, W, False, plan))
            print(f"time B={B} W={W} n={N_REF} plan={p}"
                  f"{'' if plan else ' (forward_plan)'}: gotoh_forward "
                  f"{fwd:.3f} ms, gotoh_score {sc:.3f} ms ({card})",
                  flush=True)
        torch.cuda.empty_cache()


def corr(dev, card: str) -> None:
    rng = np.random.default_rng(13)
    lut = np.array([1, 2, 4, 8] * 3 + list(range(16)), dtype=np.uint8)
    for B, Q, A in ((33, 1, 4), (300, 70, 40), (4096, 64, 256),
                    (4096, 129, 1000), (4096, 1000, 12000)):
        r = torch.from_numpy(lut[rng.integers(0, len(lut), (B, A))]).to(dev)
        q = torch.from_numpy(lut[rng.integers(0, len(lut), (Q, A))]).to(dev)
        got = sk.amb_corr(r, q)
        torch.cuda.synchronize()
        for g, w in zip(got, sk.amb_corr_plain(r, q), strict=True):
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:4].tolist()
                raise AssertionError(f"amb_corr B={B} Q={Q} A={A} differs "
                                     f"at {bad}")
        ms = timed(lambda: sk.amb_corr(r, q), reps=9)
        dev_ms = timed_graph(lambda: sk.amb_corr(r, q))
        print(f"corr B={B} Q={Q} A={A}: exact, {ms:.4f} ms a call, "
              f"{dev_ms:.4f} ms a launch inside a CUDA graph ({card})",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    what = sys.argv[1:] or ["check", "time", "corr"]
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(verbose=True)
    _build.lib()
    dev = torch.device("cuda")
    if "corr" in what:
        corr(dev, card)
    if "check" in what:
        check(dev)
    if "time" in what:
        time_all(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
