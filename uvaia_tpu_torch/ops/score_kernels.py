"""Scoring kernels and their plain PyTorch versions.

* :func:`score_counters` (csrc/score.cu, unpacked) replaces
  ``uvaia_tpu/ops/pallas_score.py:_kernel_full``;
* :func:`score_counters_packed` (csrc/score.cu, packed) replaces
  ``pallas_score.py:_kernel_full_packed``;
* :func:`amb_corr` (csrc/corr.cu) replaces ``pallas_score.py:_kernel_corr``;
* :func:`acgt_counters` (csrc/acgt.cu, unpacked) replaces
  ``pallas_score.py:_kernel_acgt_main`` + ``_kernel_acgt_poly`` (--acgt);
* :func:`acgt_counters_packed` (csrc/acgt.cu, packed) replaces
  ``pallas_score.py:_kernel_acgt_main_packed`` +
  ``_kernel_acgt_poly_packed``;
* :func:`pair_counters` (csrc/score.cu without the consensus epilogue)
  replaces ``pallas_score.py:_kernel`` (``pair_counter_mats``).

Each wrapper launches its CUDA kernel for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs the plain
version beside it, and for any other device it raises.  There is no
fallback from a CUDA tensor to a plain version.  All values are integer
counts, so kernel and plain version agree exactly.
"""

from __future__ import annotations

import contextlib

import torch

from . import _build

# ----------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held
# against on the card)


@contextlib.contextmanager
def full_float32_matmuls():
    """Turn TF32 matmuls off for the block (or the decorated function)
    and put the process-wide flag back as it was: what the engines wrap
    their exact float32 products in."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def exact_counts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, S) x (M, S) 0/1 planes -> (N, M) int32 sums over S.

    float32 holds every integer below 2**24 exactly and S < 2**24, so a
    float32 product is exact as long as it runs in full float32: TF32
    (about 10 mantissa bits) would round counts above 2048, and int8
    products in torch wrap.  Refuses to run with TF32 matmuls enabled."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "exact counts need full float32 matmuls: run inside "
            "score_kernels.full_float32_matmuls()")
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32).T).to(torch.int32)


def _pure(c: torch.Tensor) -> torch.Tensor:
    c = c.to(torch.int32)
    return (c != 0) & ((c & (c - 1)) == 0)


def _is_amb(c: torch.Tensor) -> torch.Tensor:
    c = c.to(torch.int32)
    return (c & (c - 1)) != 0


def _popc4(c: torch.Tensor) -> torch.Tensor:
    return ((c >> 0) & 1) + ((c >> 1) & 1) + ((c >> 2) & 1) + ((c >> 3) & 1)


def _acgt_matches(ri: torch.Tensor, qi: torch.Tensor) -> torch.Tensor:
    """(B, Q) count of sites where both int32 codes are the same pure
    base: one 0/1 plane product per base."""
    return sum(exact_counts(ri == (1 << bit), qi == (1 << bit))
               for bit in range(4))


def pair_counters_plain(r: torch.Tensor, q: torch.Tensor):
    """(aa, mm, vv) (B, Q) int32 from codes r (B, S), q (Q, S) — the
    counters' definitions (see csrc/score.cu), one 0/1 plane product
    per base bit."""
    ri = r.to(torch.int32)
    qi = q.to(torch.int32)
    mm = sum(exact_counts((ri >> bit) & 1, (qi >> bit) & 1)
             for bit in range(4))
    return _acgt_matches(ri, qi), mm, exact_counts(ri != 0, qi != 0)


def score_counters_plain(r: torch.Tensor, q: torch.Tensor,
                         cons: torch.Tensor):
    """(aa, mm, vv) (B, Q) int32 and cons5 (B, 5) int32 from unpacked
    codes r (B, W), q (Q, W), cons (W,) — the counters' definitions."""
    aa, mm, vv = pair_counters_plain(r, q)
    ri = r.to(torch.int32)
    c = cons.to(torch.int32)[None, :]
    v_r = ri != 0
    v_rc = v_r & (c != 0)
    eq_c = (ri == c) & v_rc
    sums = [(eq_c & _pure(c)), eq_c, (ri & c) != 0, v_rc, v_r]
    cons5 = torch.stack([s.sum(dim=1, dtype=torch.int32) for s in sums],
                        dim=1)
    return aa, mm, vv, cons5


def acgt_counters_plain(r: torch.Tensor, q_full: torch.Tensor,
                        q_poly: torch.Tensor, cons: torch.Tensor):
    """(pp, aa, ppp, aap) (B, Q) int32 and cons5 (B, 5) int32 =
    (mm_c, va_c, 0, 0, valid_sites) from unpacked codes r (B, W),
    q_full and q_poly (Q, W), cons (W,) — the --acgt counters'
    definitions (see csrc/acgt.cu)."""
    ri = r.to(torch.int32)
    pure_r = _pure(ri)
    mats = []
    for q in (q_full, q_poly):
        qi = q.to(torch.int32)
        mats += [exact_counts(pure_r, _pure(qi)), _acgt_matches(ri, qi)]
    c = cons.to(torch.int32)[None, :]
    both = pure_r & _pure(c)
    zero = torch.zeros(r.shape[0], dtype=torch.int32, device=r.device)
    cons5 = torch.stack([(both & (ri != c)).sum(dim=1, dtype=torch.int32),
                         both.sum(dim=1, dtype=torch.int32), zero, zero,
                         (ri != 0).sum(dim=1, dtype=torch.int32)], dim=1)
    return (*mats, cons5)


def unpack_codes(packed: torch.Tensor, n_sites: int) -> torch.Tensor:
    """(B, P) packed bytes -> (B, n_sites) uint8 codes (even site in
    the high nibble; inverse of ops/host.pack_codes)."""
    both = torch.stack([(packed >> 4) & 0xF, packed & 0xF], dim=-1)
    return both.reshape(packed.shape[0], -1)[:, :n_sites]


def _unpack_to(r_packed: torch.Tensor, W: int) -> torch.Tensor:
    """Packed rows -> (B, W) codes; sites past 2 * P read code 0."""
    codes = unpack_codes(r_packed, 2 * r_packed.shape[1])
    if codes.shape[1] < W:
        codes = torch.nn.functional.pad(codes, (0, W - codes.shape[1]))
    return codes


def score_counters_packed_plain(r_packed: torch.Tensor, q: torch.Tensor,
                                cons: torch.Tensor):
    """score_counters_plain fed by packed bytes (sites past 2 * P read
    code 0)."""
    return score_counters_plain(_unpack_to(r_packed, q.shape[1]), q, cons)


def acgt_counters_packed_plain(r_packed: torch.Tensor, q_full: torch.Tensor,
                               q_poly: torch.Tensor, cons: torch.Tensor):
    """acgt_counters_plain fed by packed bytes (sites past 2 * P read
    code 0)."""
    return acgt_counters_plain(_unpack_to(r_packed, q_full.shape[1]),
                               q_full, q_poly, cons)


def amb_corr_plain(r: torch.Tensor, q: torch.Tensor, chunk: int = 1 << 24):
    """(corr_t, corr_p) (B, Q) int32 from the ambiguity-column codes
    r (B, A), q (Q, A), straight from the per-site definitions, over
    row chunks of at most ``chunk`` (B, Q, A) elements."""
    B, A = r.shape
    Q = q.shape[0]
    qi = q.to(torch.int32)[None, :, :]
    q_amb = _is_amb(qi)
    rows = max(1, chunk // max(Q * A, 1))
    ts, ps = [], []
    for lo in range(0, B, rows):
        ri = r[lo:lo + rows].to(torch.int32)[:, None, :]
        both = _is_amb(ri) & q_amb                       # (b, Q, A)
        inter = ri & qi
        ts.append((both & (ri == qi)).sum(dim=2, dtype=torch.int32))
        ps.append(torch.where(both, (inter != 0).to(torch.int32)
                              - _popc4(inter), 0).sum(dim=2,
                                                      dtype=torch.int32))
    if not ts:
        z = torch.zeros((0, Q), dtype=torch.int32, device=r.device)
        return z, z.clone()
    return torch.cat(ts), torch.cat(ps)


# the ambiguity codes (two or more bases) and, among them, those of
# exactly two bases, whose complement 15 - c is one of them again
AMB_CODES = (3, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15)
PAIR_CODES = (3, 5, 6, 9, 10, 12)


def amb_corr_products(r: torch.Tensor, q: torch.Tensor):
    """amb_corr_plain as the 22 plane products csrc/corr.cu runs on the
    tensor cores (CorrMode in csrc/mma_counts.cuh), over 16 query
    planes: the one-hot planes oh_c of the 11 ambiguity codes, the four
    mask bits on ambiguous codes, and the ambiguous plane.

        corr_t = sum_c oh_c(r) . oh_c(q)
        corr_p = amb(r) . amb(q) - sum_k (amb(r) bit_k(r)) . (amb(q) bit_k(q))
                 - sum_{c of two bases} oh_c(r) . oh_{15-c}(q)

    For two ambiguous codes [(r & q) != 0] fails only when both hold
    two bases and are complements, which the last sum takes off again.
    Exact on every pair of the 16 codes."""
    ri, qi = r.to(torch.int32), q.to(torch.int32)
    ra, qa = _is_amb(ri), _is_amb(qi)
    corr_t = sum(exact_counts(ri == c, qi == c) for c in AMB_CODES)
    corr_p = exact_counts(ra, qa)
    for k in range(4):
        corr_p = corr_p - exact_counts(ra & ((ri >> k) & 1 != 0),
                                       qa & ((qi >> k) & 1 != 0))
    for c in PAIR_CODES:
        corr_p = corr_p - exact_counts(ri == c, qi == 15 - c)
    return corr_t, corr_p


# ----------------------------------------------------------------------
# wrappers


def _check_u8(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D uint8 tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _counters_launch(r, rw, packed, q, cons):
    B, Q, W = r.shape[0], q.shape[0], q.shape[1]
    dev = r.device
    out = [torch.empty((B, Q), dtype=torch.int32, device=dev)
           for _ in range(3)]
    cons5 = torch.empty((B, 5), dtype=torch.int32, device=dev)
    if B == 0:
        return (*out, cons5)
    rc = _build.lib().uvt_score_counters(
        r.data_ptr(), rw, int(packed), q.data_ptr(), cons.data_ptr(),
        B, Q, W, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        cons5.data_ptr(), _build.stream_ptr(r))
    _build.check(rc, "score_counters")
    return (*out, cons5)


def _check_counters(r, q, cons, packed: bool, q_poly=None) -> None:
    _check_u8("r", r, 2, r.device)
    _check_u8("q", q, 2, r.device)
    _check_u8("cons", cons, 1, r.device)
    if q_poly is not None:
        _check_u8("q_poly", q_poly, 2, r.device)
        if q_poly.shape != q.shape:
            raise ValueError(f"q_poly has shape {tuple(q_poly.shape)}, q "
                             f"{tuple(q.shape)}")
    W = q.shape[1]
    if cons.shape[0] != W:
        raise ValueError(f"cons has {cons.shape[0]} sites, q has {W}")
    if packed:
        if 2 * r.shape[1] > W:
            raise ValueError(f"packed rows of {r.shape[1]} bytes hold more "
                             f"sites than the query width {W}")
    elif r.shape[1] != W:
        raise ValueError(f"r has {r.shape[1]} sites, q has {W}")


def _check_kernel_shapes(q, *rows) -> None:
    """The counter kernels read 64-site chunks of 4-byte words."""
    if q.shape[1] % 64 or any(t.data_ptr() % 4 for t in (q, *rows)):
        raise ValueError("the counter kernels need W % 64 == 0 and "
                         "4-byte aligned rows")


def score_counters(r: torch.Tensor, q: torch.Tensor, cons: torch.Tensor):
    """(aa, mm, vv, cons5) from unpacked codes r (B, W), q (Q, W),
    cons (W,) — see csrc/score.cu for the definitions."""
    _check_counters(r, q, cons, packed=False)
    if not _build.use_kernel(r):
        return score_counters_plain(r, q, cons)
    _check_kernel_shapes(q, r, cons)
    out = _counters_launch(r, r.shape[1], False, q, cons)
    score_counters.launches += 1
    return out


score_counters.launches = 0


def score_counters_packed(r_packed: torch.Tensor, q: torch.Tensor,
                          cons: torch.Tensor):
    """score_counters fed by 4-bit packed rows (B, P): byte k holds
    site 2k in its high nibble and site 2k + 1 in its low nibble; sites
    past 2P read code 0."""
    _check_counters(r_packed, q, cons, packed=True)
    if not _build.use_kernel(r_packed):
        return score_counters_packed_plain(r_packed, q, cons)
    _check_kernel_shapes(q, cons)
    out = _counters_launch(r_packed, r_packed.shape[1], True, q, cons)
    score_counters_packed.launches += 1
    return out


score_counters_packed.launches = 0


def amb_corr(r: torch.Tensor, q: torch.Tensor):
    """(corr_t, corr_p) (B, Q) int32 from the ambiguity-column codes
    r (B, A), q (Q, A) — see csrc/corr.cu for the definitions."""
    _check_u8("r", r, 2, r.device)
    _check_u8("q", q, 2, r.device)
    if r.shape[1] != q.shape[1]:
        raise ValueError(f"r has {r.shape[1]} columns, q {q.shape[1]}")
    if not _build.use_kernel(r):
        return amb_corr_plain(r, q)
    B, A = r.shape
    Q = q.shape[0]
    if A % 4 or r.data_ptr() % 4 or q.data_ptr() % 4:
        raise ValueError("the correction kernel needs A % 4 == 0 and "
                         "4-byte aligned rows")
    if B == 0 or Q == 0 or A == 0:
        z = torch.zeros((B, Q), dtype=torch.int32, device=r.device)
        return z, z.clone()
    out = torch.empty((2, B, Q), dtype=torch.int32, device=r.device)
    rc = _build.lib().uvt_amb_corr(r.data_ptr(), q.data_ptr(), B, Q, A,
                                   out.data_ptr(), out.data_ptr() + 4 * B * Q,
                                   _build.stream_ptr(r))
    _build.check(rc, "amb_corr")
    amb_corr.launches += 1
    return out[0], out[1]


amb_corr.launches = 0


def _acgt_launch(r, rw, packed, q_full, q_poly, cons):
    B, Q, W = r.shape[0], q_full.shape[0], q_full.shape[1]
    dev = r.device
    out = [torch.empty((B, Q), dtype=torch.int32, device=dev)
           for _ in range(4)]
    cons5 = torch.empty((B, 5), dtype=torch.int32, device=dev)
    if B == 0:
        return (*out, cons5)
    rc = _build.lib().uvt_acgt_counters(
        r.data_ptr(), rw, int(packed), q_full.data_ptr(), q_poly.data_ptr(),
        cons.data_ptr(), B, Q, W, *(o.data_ptr() for o in out),
        cons5.data_ptr(), _build.stream_ptr(r))
    _build.check(rc, "acgt_counters")
    return (*out, cons5)


def acgt_counters(r: torch.Tensor, q_full: torch.Tensor,
                  q_poly: torch.Tensor, cons: torch.Tensor):
    """--acgt counters (pp, aa, ppp, aap, cons5) from unpacked codes
    r (B, W), q_full and q_poly (Q, W), cons (W,) — see csrc/acgt.cu for
    the definitions."""
    _check_counters(r, q_full, cons, packed=False, q_poly=q_poly)
    if not _build.use_kernel(r):
        return acgt_counters_plain(r, q_full, q_poly, cons)
    _check_kernel_shapes(q_full, r, q_poly, cons)
    out = _acgt_launch(r, r.shape[1], False, q_full, q_poly, cons)
    acgt_counters.launches += 1
    return out


acgt_counters.launches = 0


def acgt_counters_packed(r_packed: torch.Tensor, q_full: torch.Tensor,
                         q_poly: torch.Tensor, cons: torch.Tensor):
    """acgt_counters fed by 4-bit packed rows (B, P), in the layout of
    score_counters_packed."""
    _check_counters(r_packed, q_full, cons, packed=True, q_poly=q_poly)
    if not _build.use_kernel(r_packed):
        return acgt_counters_packed_plain(r_packed, q_full, q_poly, cons)
    _check_kernel_shapes(q_full, q_poly, cons)
    out = _acgt_launch(r_packed, r_packed.shape[1], True, q_full, q_poly,
                       cons)
    acgt_counters_packed.launches += 1
    return out


acgt_counters_packed.launches = 0


def pair_counters(r: torch.Tensor, q: torch.Tensor):
    """(aa, mm, vv) (B, Q) int32 from codes r (B, S), q (Q, S), any S —
    the full-mode pair counters without the consensus ones.  On the card
    both are zero-padded to a multiple of 64 sites (a code-0 site counts
    nothing), as mats_via_pallas pads to its site tile."""
    _check_u8("r", r, 2, r.device)
    _check_u8("q", q, 2, r.device)
    if r.shape[1] != q.shape[1]:
        raise ValueError(f"r has {r.shape[1]} sites, q has {q.shape[1]}")
    if not _build.use_kernel(r):
        return pair_counters_plain(r, q)
    pad = -r.shape[1] % 64
    if pad:
        r = torch.nn.functional.pad(r, (0, pad))
        q = torch.nn.functional.pad(q, (0, pad))
    _check_kernel_shapes(q, r)
    B, Q, S = r.shape[0], q.shape[0], q.shape[1]
    out = [torch.empty((B, Q), dtype=torch.int32, device=r.device)
           for _ in range(3)]
    if B == 0:
        return tuple(out)
    rc = _build.lib().uvt_pair_counters(
        r.data_ptr(), q.data_ptr(), B, Q, S, *(o.data_ptr() for o in out),
        _build.stream_ptr(r))
    _build.check(rc, "pair_counters")
    pair_counters.launches += 1
    return tuple(out)


pair_counters.launches = 0
