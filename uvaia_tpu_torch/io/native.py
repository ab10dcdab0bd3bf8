"""ctypes bridge to the port's native host library (csrc/host/fasta_io.cpp):
the FASTA reader over raw / gzip / xz files and its ranged reader of
uncompressed files (``ufa_map_*``, engine/stream.py), the sparse-delta encoder
(``ufa_delta_extract`` / ``ufa_delta_repack``, used by ops/host.py), and
the store-block digest of ``ingest`` and its inverse, the bulk row decode
of a scan's survivors (``ufa_store_block``, ``ufa_store_decode``,
io/store.py).

The counterpart of ``uvaia_tpu/io/native.py``, with its own copy of the
source and its own build.  The library is compiled with ``g++`` at first
use into ``build/uvaia_tpu_torch/`` (never next to the source), and
rebuilt when the source is newer.  Each codec is compiled in only where
its header and library are present: a machine without ``lzma.h`` gets a
library that reads raw and gzip files, and :func:`read_fasta_native`
refuses an xz file there, so the caller (io/fasta.py) reads it in
Python.  ``UVAIA_TPU_NO_NATIVE=1`` disables the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "host" / "fasta_io.cpp"
BUILD_DIR = _PKG.parent / "build" / "uvaia_tpu_torch"
LIB_PATH = BUILD_DIR / "libuvaia_tpu_torch_io.so"

# codec -> (header probe program, link flag, define that compiles it out)
_CODECS = {
    "xz": ("#include <lzma.h>\nint main() { return "
           "lzma_version_number() == 0; }\n", "-llzma", "-DUFA_NO_LZMA"),
    "gz": ("#include <zlib.h>\nint main() { return "
           "zlibVersion() == 0; }\n", "-lz", "-DUFA_NO_ZLIB"),
}
# bits of ufa_codecs()
CODEC_BITS = {"xz": 1, "gz": 2}

_lib = None
_lock = threading.Lock()
_failed = False


def _probe(program: str, flag: str) -> bool:
    """True when a program using the codec compiles and links here."""
    with tempfile.TemporaryDirectory() as tmp:
        try:
            r = subprocess.run(
                ["g++", "-x", "c++", "-", "-o", os.path.join(tmp, "probe"),
                 flag], input=program, capture_output=True, text=True,
                timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            return False
    return r.returncode == 0


def build(out: Path = LIB_PATH, xz: bool = True) -> Path:
    """Compile the library into ``out`` with every codec that is
    available (its header and library link), xz only when asked; raises
    RuntimeError with g++'s output when the build fails."""
    flags = []
    for codec, want in (("xz", xz), ("gz", True)):
        program, link, off = _CODECS[codec]
        flags.append(link if want and _probe(program, link) else off)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so")
    os.close(fd)
    try:
        r = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread",
                            "-std=c++17", str(SRC), "-o", tmp,
                            *(f for f in flags if f.startswith("-D")),
                            *(f for f in flags if f.startswith("-l"))],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"native IO build failed:\n{r.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(path: Path):
    """Load a built library and declare its C signatures."""
    lib = ctypes.CDLL(str(path))
    lib.ufa_codecs.restype = ctypes.c_int
    lib.ufa_codecs.argtypes = []
    lib.ufa_open.restype = ctypes.c_void_p
    lib.ufa_open.argtypes = [ctypes.c_char_p]
    lib.ufa_next.restype = ctypes.c_int
    lib.ufa_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
    lib.ufa_close.restype = None
    lib.ufa_close.argtypes = [ctypes.c_void_p]
    lib.ufa_next_batch.restype = ctypes.c_long
    lib.ufa_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long)]
    lib.ufa_map_open.restype = ctypes.c_void_p
    lib.ufa_map_open.argtypes = [ctypes.c_char_p]
    lib.ufa_map_close.restype = None
    lib.ufa_map_close.argtypes = [ctypes.c_void_p]
    lib.ufa_map_find.restype = ctypes.c_long
    lib.ufa_map_find.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ufa_map_parse.restype = None
    lib.ufa_map_parse.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.ufa_delta_extract.restype = ctypes.c_long
    lib.ufa_delta_extract.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ufa_delta_repack.restype = None
    lib.ufa_delta_repack.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p]
    lib.ufa_store_block.restype = ctypes.c_long
    lib.ufa_store_block.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p]
    lib.ufa_store_decode.restype = ctypes.c_long
    lib.ufa_store_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def codecs(lib) -> list[str]:
    """The compressed formats ``lib`` reads natively (raw always)."""
    bits = lib.ufa_codecs()
    return [c for c, b in CODEC_BITS.items() if bits & b]


def get_lib():
    """The loaded native library, or None if it cannot be built here."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        if os.environ.get("UVAIA_TPU_NO_NATIVE"):
            _failed = True
            return None
        try:
            if not LIB_PATH.exists() or \
                    LIB_PATH.stat().st_mtime < SRC.stat().st_mtime:
                build()
            _lib = load(LIB_PATH)
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            print(f"uvaia_tpu_torch: native IO library unavailable, using "
                  f"the Python reader and encoder: {e}", file=sys.stderr)
            _failed = True
    return _lib


def read_fasta_native(path, lib=None):
    """Generator of (name: str, seq: bytes); raises RuntimeError if the
    native reader cannot handle the file (no library, or a codec the
    library was built without)."""
    lib = lib if lib is not None else get_lib()
    if lib is None:
        raise RuntimeError("native reader unavailable")
    handle = lib.ufa_open(str(path).encode())
    if not handle:
        raise RuntimeError(f"native reader cannot open {path}")
    name_p = ctypes.c_char_p()
    name_l = ctypes.c_size_t()
    seq_p = ctypes.c_void_p()
    seq_l = ctypes.c_size_t()
    try:
        while True:
            rc = lib.ufa_next(handle, ctypes.byref(name_p),
                              ctypes.byref(name_l), ctypes.byref(seq_p),
                              ctypes.byref(seq_l))
            if rc == 0:
                return
            if rc < 0:
                raise RuntimeError(f"native reader error in {path}")
            name = ctypes.string_at(name_p, name_l.value).decode(
                "utf-8", errors="replace")
            seq = ctypes.string_at(seq_p, seq_l.value)
            yield name, seq
    finally:
        lib.ufa_close(handle)
