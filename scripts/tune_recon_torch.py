"""Check and time the delta rebuild kernel on one NVIDIA GPU.

    python scripts/tune_recon_torch.py [check] [time]

Builds the kernel library (printing ptxas' registers, shared memory and
spills for recon.cu) and the one-CTA-a-row kernel it replaced
(scripts/recon_row_per_cta.cu), then
  * `check`: csrc/recon.cu and the one-CTA-a-row kernel against the
    plain PyTorch version, exactly, on synthetic entries at B = 4096,
    L = 29,903 (E in {128, 1024, 4096}, uint16 and int32 positions,
    w = 30,720 and the ragged w = L, the same entries with their slots
    shuffled, a base that is not 16-byte aligned);
  * `time`: the kernel at each E and width beside the one-CTA-a-row
    kernel and the bytes-over-3.35-TB/s bound: the CUDA-event median of
    a call (host work included: about half of a 0.1 ms call) and of a
    launch inside a CUDA graph (the device alone).
  * `variants`: the time's split, from patched copies of csrc/recon.cu
    built beside it (not checked: some give wrong rows): 1, 2, 3, 6 and
    8 CTAs an SM in place of the kernel's 4, the image kept
    across rows with the painted sites taken back one by one, no re-read
    of the base, scalar entry loads, the store alone; beside `zero_()`
    and `copy_()` of the same (B, w) bytes, the card's own write-only
    and copy times.
Without arguments `check` and `time` run.  Prints the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from uvaia_tpu_torch.ops import _build, recon  # noqa: E402

B, L, W = 4096, 29903, 30720


def batch(dev, E, dtype, seed=5, shuffle=False):
    rng = np.random.default_rng(seed)
    pos, val = chip_smoke.synthetic_deltas(rng, B, E, L, dtype)
    if shuffle:
        order = rng.permuted(np.tile(np.arange(E), (B, 1)), axis=1)
        pos = np.take_along_axis(pos, order, 1)
        val = np.take_along_axis(val, order, 1)
    return [torch.from_numpy(x).to(dev) for x in (pos, val)]


def row_per_cta_rebuild():
    """The one-CTA-a-row rebuild (scripts/recon_row_per_cta.cu, the
    design csrc/recon.cu replaced), built here and bound with ctypes: a
    callable (pos, val, base, width) -> rows, checked and timed beside
    the kernel.  The port never calls it."""
    src = ROOT / "scripts" / "recon_row_per_cta.cu"
    lib_path = _build.BUILD_DIR / "librecon_row_per_cta.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(src)], check=True)
    fn = ctypes.CDLL(str(lib_path)).uvt_delta_rebuild_row_per_cta
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, P, P, I, I, I, I, P, P]
    fn.restype = I

    def rebuild(pos, val, base, width):
        out = torch.empty((pos.shape[0], width), dtype=torch.uint8,
                          device=pos.device)
        _build.check(fn(pos.data_ptr(), pos.element_size(), val.data_ptr(),
                        base.data_ptr(), *pos.shape, base.shape[0], width,
                        out.data_ptr(), _build.stream_ptr(pos)),
                     "row_per_cta_rebuild")
        return out
    return rebuild


# name -> (old, new) text patches of csrc/recon.cu
_REREAD = ("    init_row(row, base, L, wpad);\n    __syncthreads();\n\n"
           "    // paint")
_PAINT = "    for (int c = tid; c < nchunks; c += kThreads) {\n      load8("
_STORE_END = "    store_row(row, out + b * w, w);\n    __syncthreads();\n  }\n}"
_CTAS = "constexpr int kCtasPerSm = 4;"
VARIANTS = {
    "as_built": [],
    **{f"ctas_per_sm_{n}": [(_CTAS, _CTAS.replace("4", str(n)))]
       for n in (1, 2, 3, 6, 8)},
    # the image filled once a CTA; a row's painted sites taken back from
    # the base one by one after the store (its runs are not)
    "take_back_by_site": [
        (_REREAD, "    if (b == blockIdx.x) init_row(row, base, L, wpad);\n"
                  "    __syncthreads();\n\n    // paint"),
        (_STORE_END,
         "    store_row(row, out + b * w, w);\n    __syncthreads();\n"
         "    for (int e = tid; e < E; e += kThreads) {\n"
         "      const unsigned q = static_cast<unsigned>(prow[e]);\n"
         "      if (q < uL) row[q] = __ldg(base + q);\n    }\n  }\n}")],
    "no_base_reread": [
        (_REREAD, "    __syncthreads();\n\n    // paint")],
    "scalar_entry_loads": [("  const bool wide = (E & 7) == 0",
                            "  const bool wide = false && (E & 7) == 0")],
    "store_alone": [
        (_REREAD, "    __syncthreads();\n\n    // paint"),
        (_PAINT, "    for (int c = tid; c < 0; c += kThreads) {\n      load8(")],
}


def build_variants() -> dict:
    """Each variant's library handle, from a patched copy of recon.cu."""
    out = _build.BUILD_DIR / "tune_recon"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "recon.cu").read_text()
    cmds, libs = [], {}
    for name, patches in VARIANTS.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: patch target not found: {old!r}")
            src = src.replace(old, new)
        (out / f"{name}.cu").write_text(src)
        libs[name] = out / f"lib_{name}.so"
        cmds.append([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                     "-Xcompiler", "-fPIC", "-shared", "-o", str(libs[name]),
                     str(out / f"{name}.cu")])
    for r in _build._run_all(cmds):
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(r.args)}\n{r.stderr}")
    handles = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).uvt_delta_rebuild
        fn.argtypes = _build._SIGNATURES["uvt_delta_rebuild"]
        fn.restype = ctypes.c_int
        handles[name] = fn
    return handles


def time_variants(dev, base) -> None:
    handles = build_variants()
    out = torch.empty((B, W), dtype=torch.uint8, device=dev)
    src = torch.ones((B, W), dtype=torch.uint8, device=dev)
    ms = chip_smoke.timed_graph_ms
    print(f"variants B={B} w={W}, ms on the device alone: zero_() "
          f"{ms(out.zero_):.4f}, copy_() {ms(lambda: out.copy_(src)):.4f}",
          flush=True)
    for E in (128, 1024, 4096):
        pos, val = batch(dev, E, np.uint16)
        for name, fn in handles.items():
            def call():
                _build.check(fn(
                    pos.data_ptr(), 2, val.data_ptr(), base.data_ptr(),
                    B, E, L, W, out.data_ptr(), _build.stream_ptr(pos)),
                    name)
            print(f"variant {name} E={E}: {ms(call):.4f}", flush=True)
    shutil.rmtree(_build.BUILD_DIR / "tune_recon", ignore_errors=True)


def main() -> int:
    what = set(sys.argv[1:]) or {"check", "time"}
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    _build.build(verbose=True)
    earlier = row_per_cta_rebuild()
    rng = np.random.default_rng(1)
    base_np = rng.integers(0, 16, L + 3).astype(np.uint8)
    base = torch.from_numpy(base_np[:L]).to(dev)
    base_odd = torch.from_numpy(base_np).to(dev)[3:]
    shapes = [(128, np.uint16, W), (1024, np.uint16, W), (4096, np.uint16, W),
              (128, np.int32, W), (128, np.uint16, L), (1024, np.int32, L)]
    if "check" in what:
        for E, dt, w in shapes:
            for shuffle in (False, True):
                pos, val = batch(dev, E, dt, shuffle=shuffle)
                for b in (base, base_odd):
                    want = recon.delta_rebuild_plain(pos, val, b, w)
                    for name, fn in (("kernel", recon.delta_rebuild),
                                     ("one CTA a row", earlier)):
                        got = fn(pos, val, b, w)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
                            bad = (got != want).nonzero()
                            raise AssertionError(
                                f"{name} E={E} {dt.__name__} w={w} "
                                f"shuffle={shuffle}: {len(bad)} bytes "
                                f"differ, first at {bad[0]}")
                    del want, got
                print(f"check E={E} {dt.__name__} w={w} "
                      f"shuffle={shuffle}: exact", flush=True)
    if "time" in what:
        for E, dt, w in shapes:
            for shuffle in (False, True):
                if shuffle and (E, w) != (128, W):
                    continue
                pos, val = batch(dev, E, dt, shuffle=shuffle)
                bnd = chip_smoke.rebuild_bound(pos, val, L, w)
                both = lambda fn: (
                    f"{chip_smoke.timed_ms(fn):.4f} / "
                    f"{chip_smoke.timed_graph_ms(fn):.4f}")
                print(f"time E={E} {dt.__name__} w={w} shuffle={shuffle} "
                      f"(ms a call / ms on the device alone): bound "
                      f"{bnd['bound_ms']:.4f}, one CTA a row "
                      f"{both(lambda: earlier(pos, val, base, w))}, kernel "
                      f"{both(lambda: recon.delta_rebuild(pos, val, base, w))}",
                      flush=True)
    if "variants" in what:
        time_variants(dev, base)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
