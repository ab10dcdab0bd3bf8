"""Time variants of the tensor-core counter kernels on one NVIDIA GPU.

    python scripts/tune_counters_torch.py [VARIANT ...]

Builds uvaia_tpu_torch/csrc/score.cu and acgt.cu once per variant into
build/tune_counters/, one nvcc process a variant, all started together:
  * `default`, the tile routine as it is (csrc/mma_counts.cuh), which
    must equal the plain PyTorch versions exactly;
  * a time split: copies of the routine with one part switched off (the
    products, the query-plane staging, the consensus counters, the
    reference flag words), whose outputs are wrong by construction and
    are not checked — the time each saves is what that part costs.
With variant names as arguments only those run (default: all).
Each variant runs in a process of its own (two libraries holding the
same kernel names do not share a process) on the same synthetic inputs
(B=4096 references, W=30720 sites, Q = 7, 64, 129, 1000, from one seed);
the script prints CUDA-event medians per variant and shape, and the
card's name and power limit.  A refused launch is reported and skipped.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from uvaia_tpu_torch.ops import _build  # noqa: E402

OUT = ROOT / "build" / "tune_counters"
# name -> text patches of a copy of mma_counts.cuh
_NO_PRODUCTS = ("        wgmma_s8(acc[M::counter(p)], a[p],\n"
                "                 kmajor_desc(qp + p * kQPlaneWords + ks * kKStepWords));",
                "        (void)qp;")
_NO_QUERY_STAGING = ("    for (int p = 0; p < M::kQPlanes; ++p)\n"
                     "      *reinterpret_cast<uint4*>(qp + p * kQPlaneWords) =",
                     "    for (int p = 0; p < 0; ++p)\n"
                     "      *reinterpret_cast<uint4*>(qp + p * kQPlaneWords) =")
_NO_CONSENSUS = ("  const bool do_cons = kCons && blockIdx.y == 0;",
                 "  const bool do_cons = false;")
_NO_FLAGS = ("      f[j] = pure_bytes(x[j]) | (nz_bytes(x[j]) << 1);",
             "      f[j] = x[j];")
VARIANTS = {"default": [],
            "no_products": [_NO_PRODUCTS],
            "no_query_staging": [_NO_QUERY_STAGING],
            "no_consensus": [_NO_CONSENSUS],
            "no_ref_flags": [_NO_FLAGS],
            "products_only": [_NO_QUERY_STAGING, _NO_CONSENSUS, _NO_FLAGS]}
B, W = 4096, 30720


def _sources(name: str, patches) -> list[str]:
    """score.cu and acgt.cu, from a patched copy of csrc when the
    variant switches a part off."""
    src = _build.CSRC
    if patches:
        src = OUT / f"csrc_{name}"
        shutil.copytree(_build.CSRC, src, dirs_exist_ok=True)
        head = (src / "mma_counts.cuh").read_text()
        for old, new in patches:
            if head.count(old) != 1:
                raise RuntimeError(f"{name}: patch target not found: {old!r}")
            head = head.replace(old, new)
        (src / "mma_counts.cuh").write_text(head)
    return [str(src / "score.cu"), str(src / "acgt.cu")]


def build_all(names) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    libs = {name: OUT / f"lib_{name}.so" for name in names}
    cmds = [[nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
             "-fPIC", "-shared", "-o", str(lib),
             *_sources(name, VARIANTS[name])]
            for name, lib in libs.items()]
    for r in _build._run_all(cmds):
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(r.args)}\n{r.stderr}")
    return libs


def timed(fn, reps: int = 9) -> float:
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


def run_variant(name: str, lib: Path, card: str) -> None:
    from uvaia_tpu_torch.ops import score_kernels as sk
    h = ctypes.CDLL(str(lib))
    for fn in ("uvt_score_counters", "uvt_acgt_counters"):
        getattr(h, fn).argtypes = _build._SIGNATURES[fn]
        getattr(h, fn).restype = ctypes.c_int
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    lut = np.array([1, 2, 4, 8] * 6 + [0, 3, 5, 12], dtype=np.uint8)
    r = torch.from_numpy(lut[rng.integers(0, len(lut), (B, W))]).to(dev)
    cons = torch.from_numpy(lut[rng.integers(0, len(lut), W)]).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    for Q in (7, 64, 129, 1000):
        q = torch.from_numpy(lut[rng.integers(0, len(lut), (Q, W))]).to(dev)
        keep = torch.from_numpy(rng.random((Q, W)) < 0.5).to(dev)
        p = torch.where(keep, q, 0).to(torch.uint8).contiguous()
        outs = [torch.empty((B, Q), dtype=torch.int32, device=dev)
                for _ in range(4)]
        c5 = torch.empty((B, 5), dtype=torch.int32, device=dev)
        calls = {
            "score": (lambda: h.uvt_score_counters(
                r.data_ptr(), W, 0, q.data_ptr(), cons.data_ptr(), B, Q, W,
                *(o.data_ptr() for o in outs[:3]), c5.data_ptr(), stream),
                lambda: sk.score_counters_plain(r, q, cons), 3),
            "acgt": (lambda: h.uvt_acgt_counters(
                r.data_ptr(), W, 0, q.data_ptr(), p.data_ptr(),
                cons.data_ptr(), B, Q, W, *(o.data_ptr() for o in outs),
                c5.data_ptr(), stream),
                lambda: sk.acgt_counters_plain(r, q, p, cons), 4)}
        for kind, (call, plain, n) in calls.items():
            rc = call()
            torch.cuda.synchronize()
            if rc != 0:
                print(f"{name} {kind} Q={Q}: launch refused (CUDA error "
                      f"{rc})", flush=True)
                continue
            checked = not VARIANTS[name]
            if checked and not all(
                    torch.equal(a, b) for a, b in
                    zip((*outs[:n], c5), plain(), strict=True)):
                raise AssertionError(f"{name} {kind} Q={Q} differs from "
                                     "the plain version")
            print(f"{name} {kind} B={B} W={W} Q={Q}: {timed(call):.4f} ms, "
                  f"{'exact' if checked else 'not checked'} ({card})",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    if sys.argv[1:2] == ["--child"]:
        run_variant(sys.argv[2], Path(sys.argv[3]), card)
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
        return 2
    rc = 0
    for name, lib in build_all(names).items():
        rc |= subprocess.run([sys.executable, __file__, "--child", name,
                              str(lib)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
