"""Build and load the port's CUDA kernels at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds, not minutes).  The
library lives in ``build/uvaia_tpu_torch/`` beside the package and is
rebuilt when any source under ``csrc/`` is newer.  Nothing here runs at
import time: the CPU-only test machines import every module.

Each C entry point returns ``cudaGetLastError()``; :func:`check`
raises on anything but 0, so a launch that was refused never passes
silently.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "uvaia_tpu_torch"
LIB_PATH = BUILD_DIR / "libuvaia_tpu_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
# C signatures (csrc/*.cu): every pointer and the stream as c_void_p
_SIGNATURES = {
    "uvt_score_counters": [_P, _L, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                           _P],
    "uvt_pair_counters": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "uvt_acgt_counters": [_P, _L, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                          _P, _P, _P],
    "uvt_amb_corr": [_P, _P, _I, _I, _I, _P, _P, _P],
    "uvt_delta_rebuild": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    "uvt_gotoh_forward": [_P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P,
                          _P, _P],
    "uvt_gotoh_score": [_P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built
               for p in list(_sources()) + list(CSRC.glob("*.cuh")))


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands concurrently; their results in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    out = [p.communicate() for p in procs]
    return [subprocess.CompletedProcess(c, p.returncode, *o)
            for c, p, o in zip(cmds, procs, out)]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into LIB_PATH if missing or stale; raises
    RuntimeError with nvcc's output when the build fails."""
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects in a private directory, then link to a temporary name and
    # rename: a concurrent process never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in _sources()]
        cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                 "-fPIC", *(["-Xptxas=-v"] if verbose else []), "-c",
                 "-o", obj, str(src)]
                for src, obj in zip(_sources(), objs)]
        lib_tmp = str(Path(tmp) / LIB_PATH.name)
        for step in (cmds, [[nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp,
                             *objs]]):
            for r in _run_all(step):
                if r.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                                       f"{' '.join(r.args)}\n"
                                       f"{r.stdout}{r.stderr}")
                if verbose and (r.stdout or r.stderr):
                    print(r.stdout + r.stderr, flush=True)
        os.replace(lib_tmp, LIB_PATH)
    return LIB_PATH


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def use_kernel(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises.  A CUDA tensor
    never takes the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t) -> int:
    """Raw pointer of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
