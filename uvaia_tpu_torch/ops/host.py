"""Host-side (numpy) encoders and constants of the scan, free of any
device framework.

Byte-identical copies of the numpy code in ``uvaia_tpu/ops/scan.py``
(``_pad_to``, ``majority_code``, ``pack_codes`` and the sparse-delta
encoder), which sits behind that module's top-level ``jax`` import.
The port imports them from here so that nothing on its path needs jax.
The native diff scan is the port's own copy of the JAX package's
(csrc/host/fasta_io.cpp, loaded by io/native.py).
"""

from __future__ import annotations

import threading

import numpy as np

INT32_MIN = np.int32(-2**31)
IDX_SENTINEL = np.int32(2**31 - 1)

# Single source of truth for the ranking-key definition: six int scores
# packed two-per-int32 key with this shift (requires each score < 2**15,
# QueryDeviceData.pack_keys).
KEY_SHIFT = 32768


def _pad_to(x: np.ndarray, mult: int, axis: int = 0, value=0) -> np.ndarray:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


def majority_code(codes: np.ndarray) -> np.ndarray:
    """(Q, L) -> (L,) most frequent code per site (the delta base).

    Database rows are expected to be close to the queries, so the
    per-site query majority minimises the expected diff count of
    delta_encode.  Any fixed vector is *correct* (reconstruction is
    exact); this one just keeps the uploads small."""
    counts = np.zeros((16, codes.shape[1]), dtype=np.int32)
    for c in range(16):
        counts[c] = (codes == c).sum(axis=0)
    return counts.argmax(axis=0).astype(np.uint8)


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Host-side: pack two 4-bit codes per byte (halves H2D traffic).
    Pads an odd site count with code 0."""
    B, L = codes.shape
    if L % 2:
        codes = np.ascontiguousarray(
            np.pad(codes, ((0, 0), (0, 1))))
    pairs = codes.reshape(B, -1, 2)       # contiguous, vectorises cleanly
    return (pairs[:, :, 0] << 4 | pairs[:, :, 1]).astype(np.uint8)


# ----------------------------------------------------------------------
# sparse-delta uploads: most database genomes differ from the query
# majority at only ~10^2 of ~3*10^4 sites (SNPs + masked runs), so a
# (position, code) diff list at 3 bytes/site is ~10-50x smaller than the
# 4-bit packed row; the exact codes are rebuilt on the device
# (ops/recon.delta_rebuild).

DELTA_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


def _delta_lib():
    """Native encoder (csrc/host/fasta_io.cpp:ufa_delta_extract/repack,
    the port's own library), or None."""
    from ..io import native
    return native.get_lib()


# per-thread scratch (B -> (pos, val, counts)): delta_encode may run
# from several encode workers at once, so the buffers cannot be
# process-global; thread-local keeps each caller race-free without a
# lock (at ~12MB per thread per distinct B).
_delta_tls = threading.local()


def _rle_rewrite(row: np.ndarray, p: np.ndarray, v: np.ndarray):
    """Python mirror of the C encoder's in-place zero-run rewrite
    (fasta_io.cpp ufa_delta_extract): maximal runs of row zeros whose
    plain encoding takes >2 entries become (s, 16) + (e, 32 + row[e])
    markers (start only when the run reaches the row end).  Keeps the
    no-native path's output identical to the native one."""
    L = row.shape[0]
    op, ov = [], []
    i, c = 0, len(p)
    while i < c:
        if v[i] != 0:
            op.append(p[i]); ov.append(v[i]); i += 1
            continue
        s = e = int(p[i])
        while s > 0 and row[s - 1] == 0:
            s -= 1
        e += 1
        while e < L and row[e] == 0:
            e += 1
        j = i
        while j < c and p[j] < e:
            j += 1
        j2 = j + (1 if e < L and j < c and p[j] == e else 0)
        mcost = 2 if e < L else 1
        if j2 - i > mcost:
            op.append(s); ov.append(16)
            if e < L:
                op.append(e); ov.append(32 + int(row[e]))
            i = j2
        else:
            for k in range(i, j):
                op.append(p[k]); ov.append(0)
            i = j
    return op, ov


def delta_encode(codes: np.ndarray, ok: np.ndarray, base: np.ndarray):
    """Host-side: diff (B, L) uint8 rows against `base`.

    Returns (pos (B, E) uint16, val (B, E) uint8) with E the smallest
    bucket holding the fattest row, or None when a row exceeds the
    largest bucket (caller falls back to the 4-bit packed upload —
    beyond ~L/8 diffs the delta stops paying).  Long masked runs
    (N/'-' stretches encoding to 0) compress to start/end markers
    (val 16-47, see _rle_rewrite) instead of per-site entries.  Padding
    slots carry pos = L + slot so the device-side rebuild drops them
    (unique, ascending, out of range).  Rows with ok=False encode as
    empty (their scores are masked downstream).

    The diff scan runs in the native library when available (a numpy
    nonzero over (B, L) costs ~25x the C++ XOR scan)."""
    B, L = codes.shape
    cap = DELTA_BUCKETS[-1]
    lib = _delta_lib()
    if lib is not None and L + cap < 2**16:
        import ctypes
        scratch = getattr(_delta_tls, "scratch", None)
        if scratch is None:
            scratch = _delta_tls.scratch = {}
        if B not in scratch:
            scratch[B] = (np.empty((B, cap), dtype=np.uint16),
                          np.empty((B, cap), dtype=np.uint8),
                          np.empty(B, dtype=np.int64))
        spos, sval, counts = scratch[B]
        codes = np.ascontiguousarray(codes)
        base_c = np.ascontiguousarray(base)
        okb = np.ascontiguousarray(ok.astype(np.uint8))
        top = lib.ufa_delta_extract(
            codes.ctypes.data_as(ctypes.c_void_p), B, L,
            base_c.ctypes.data_as(ctypes.c_void_p),
            okb.ctypes.data_as(ctypes.c_void_p), cap,
            spos.ctypes.data_as(ctypes.c_void_p),
            sval.ctypes.data_as(ctypes.c_void_p),
            counts.ctypes.data_as(ctypes.c_void_p))
        if top < 0:
            return None
        E = next(b for b in DELTA_BUCKETS if b >= top)
        pos = np.empty((B, E), dtype=np.uint16)
        val = np.empty((B, E), dtype=np.uint8)
        lib.ufa_delta_repack(
            spos.ctypes.data_as(ctypes.c_void_p),
            sval.ctypes.data_as(ctypes.c_void_p), B, cap,
            counts.ctypes.data_as(ctypes.c_void_p), E, L,
            pos.ctypes.data_as(ctypes.c_void_p),
            val.ctypes.data_as(ctypes.c_void_p))
        return pos, val
    diff = codes != base[None, :]
    if not ok.all():
        diff &= ok[:, None]
    rewritten = []
    top = 0
    for r in range(B):
        cols = np.nonzero(diff[r])[0]
        op, ov = _rle_rewrite(codes[r], cols, codes[r, cols])
        if len(op) > DELTA_BUCKETS[-1]:
            return None
        rewritten.append((op, ov))
        top = max(top, len(op))
    E = next((b for b in DELTA_BUCKETS if b >= top), None)
    if E is None:
        return None
    pdt = np.uint16 if L + E < 2**16 else np.uint32
    pos = np.broadcast_to(
        np.arange(L, L + E, dtype=pdt)[None, :], (B, E)).copy()
    val = np.zeros((B, E), dtype=np.uint8)
    for r, (op, ov) in enumerate(rewritten):
        pos[r, :len(op)] = op
        val[r, :len(ov)] = ov
    return pos, val
