"""Distances for the radius search (``ball``) and the in-memory searcher
(``legacy``) on PyTorch: the counterpart of ``uvaia_tpu/ops/distance.py``.

* :func:`cons_mismatches` — per-reference mismatch count against the
  query consensus over a site subset (ball stages 1+2).
* :func:`pair_mismatches` — exact (B, Q) mismatch matrix over the
  polymorphic-site subset (ball stage 3).
* :func:`legacy_scores` — the legacy searcher's per-pair counters: ACGT
  matches, char matches among valid pairs, IUPAC-weighted partial
  matches (T vs W = 0.5), valid pairs.

None of these was a Pallas kernel in the JAX package (XLA integer
products); here they are torch ops.  Every product is an exact integer
sum: operands are small integers, the product runs as a float32 matmul
over site chunks whose sums stay below 2**24 (int8 products wrap in
torch, TF32 would round), and the chunks add up in int64.  So results do
not depend on the device or on the order of summation.

The weighted partial match is such a sum too.  A site's weight is
|r & q| / (|r| |q|) (or, between two ambiguity codes, the chosen rule's
|r & q| / |r | q| or / max(|r|, |q|)): every value is a multiple of
1/144, so 144 times the sum is an integer, computed exactly and divided
once, in float64.  The JAX package sums the same terms in float32, in
the order its backend picks; the two agree to float32's rounding of a
sum of L terms (relative 1e-6 here), and exactly wherever no three-base
code (B, D, H, V) meets a code it shares a base with, all other weights
being binary fractions.  A printed ``%13.3f`` of the legacy table can
differ in the third decimal only there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.encoding import IS_AMBIG, IS_PURE, POPCOUNT4
from .scan import _pure

PARTIAL_SCALE = 144        # lcm of every |r| |q|, |r | q| and max(|r|, |q|)
_EXACT = 1 << 24           # float32 holds every integer below this


def exact_dot(r_planes, q_planes, max_term: int = 1) -> torch.Tensor:
    """sum_k r_planes[k] (B, S) @ q_planes[k] (Q, S).T as int64, exactly,
    for small non-negative integer planes whose per-site products summed
    over k stay within `max_term`.  Refuses TF32 matmuls on the card."""
    r0, q0 = r_planes[0], q_planes[0]
    if r0.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "exact integer products need full float32 matmuls: run "
            "inside score_kernels.full_float32_matmuls()")
    S = r0.shape[1]
    step = max(1, (_EXACT - 1) // max(max_term, 1))
    acc = torch.zeros((r0.shape[0], q0.shape[0]), dtype=torch.int64,
                      device=r0.device)
    for s0 in range(0, S, step):
        part = None
        for rp, qp in zip(r_planes, q_planes, strict=True):
            m = torch.matmul(rp[:, s0:s0 + step].to(torch.float32),
                             qp[:, s0:s0 + step].to(torch.float32).T)
            part = m if part is None else part + m
        acc += part.to(torch.int64)
    return acc


def mismatch_weights(q_sub: np.ndarray, acgt: bool) -> np.ndarray:
    """(Q, P, 16) int8: weight[q, p, c] = 1 iff ref code c mismatches
    query q at subset position p (mode-dependent)."""
    codes16 = np.arange(16, dtype=np.uint8)
    cq = q_sub[..., None]                       # (Q, P, 1)
    if acgt:
        w = (IS_PURE[cq] != 0) & (IS_PURE[codes16] != 0) & (cq != codes16)
    else:
        w = (cq != 0) & (codes16 != 0) & (cq != codes16)
    return w.astype(np.int8)


def _one_hot_dot(codes: torch.Tensor, weights: torch.Tensor,
                 max_term: int = 1) -> torch.Tensor:
    """sum_p weights[q, p, codes[b, p]] as (B, Q) int64: one product a
    code value (no (B, P, 16) one-hot in memory); code 0 has no weight
    in any table here."""
    return exact_dot([codes == c for c in range(1, 16)],
                     [weights[:, :, c] for c in range(1, 16)], max_term)


def pair_mismatches(ref_sub: torch.Tensor, weights: torch.Tensor):
    """ref_sub (B, P) uint8 codes, weights (Q, P, 16) -> (B, Q) int32."""
    return _one_hot_dot(ref_sub, weights).to(torch.int32)


def cons_mismatches(ref_codes: torch.Tensor, sites: torch.Tensor,
                    cons: torch.Tensor, acgt: bool):
    """(B,) int32 mismatches of each ref against consensus codes at
    `sites` (text-valid-pair or acgt-pair semantics)."""
    rc = ref_codes.index_select(1, sites.long())
    c = cons[None, :]
    if acgt:
        both = _pure(rc) & _pure(c)
        return (both & (rc != c)).sum(dim=1, dtype=torch.int32)
    valid = (rc != 0) & (c != 0)
    return (valid & (rc != c)).sum(dim=1, dtype=torch.int32)


# ----------------------------------------------------------------------
# legacy in-memory scoring


def build_legacy_query_data(q_codes: np.ndarray, trim: int,
                            partial_rule: str = "product", device="cpu"):
    """Precompute query-side features for legacy_scores, as tensors on
    `device`.

    ``partial_rule`` selects the ambiguity-vs-ambiguity entries of the
    weighted-partial table (product is the documented default; jaccard /
    max are the other candidates consistent with the recoverable pins).
    Non-product rules add a sparse per-amb-column correction plane;
    every other counter is rule-independent.

    Against the JAX package's dict: ``a_q``, ``v_q``, ``amb_cols``,
    ``w_text`` and ``window`` are the same arrays; ``mn_q`` holds
    12 bits / |q| (integers; 12 times the JAX package's float plane)
    and ``w_part`` holds 144 (rule - product) (integers)."""
    if partial_rule not in ("product", "jaccard", "max"):
        raise ValueError(f"unknown partial rule {partial_rule!r}")
    Q, L = q_codes.shape
    window = np.zeros(L, dtype=bool)
    window[trim:L - trim if trim else L] = True
    q = np.where(window[None, :], q_codes, 0).astype(np.uint8)

    bits = np.stack([(q >> i) & 1 for i in range(4)], -1).astype(np.int8)
    pure = (POPCOUNT4[q] == 1)
    a_q = bits * pure[..., None].astype(np.int8)
    v_q = (q != 0).astype(np.int8)
    pop = np.maximum(POPCOUNT4[q].astype(np.int8), 1)
    mn_q = bits * (12 // pop)[..., None]

    amb_cols = np.nonzero((IS_AMBIG[q] != 0).any(axis=0))[0].astype(np.int32)
    codes16 = np.arange(16, dtype=np.uint8)
    cq = q[:, amb_cols, None]
    w_text = ((cq == codes16) & (IS_AMBIG[cq] != 0)).astype(np.int8)
    w_part = None
    if partial_rule != "product":
        # 144 (rule - product) per (query code, ref code): nonzero only
        # when BOTH codes are ambiguity codes, so the correction rides
        # the same amb-column one-hot products as w_text
        both = (IS_AMBIG[cq] != 0) & (IS_AMBIG[codes16] != 0)
        inter = POPCOUNT4[cq & codes16].astype(np.int64)
        p1 = POPCOUNT4[cq].astype(np.int64)
        p2 = POPCOUNT4[codes16].astype(np.int64)
        prod = PARTIAL_SCALE * inter // np.maximum(p1 * p2, 1)
        if partial_rule == "jaccard":
            alt = PARTIAL_SCALE * inter // np.maximum(
                POPCOUNT4[cq | codes16].astype(np.int64), 1)
        else:
            alt = PARTIAL_SCALE * inter // np.maximum(np.maximum(p1, p2), 1)
        w_part = ((alt - prod) * both).astype(np.int16)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return dict(a_q=up(a_q), v_q=up(v_q), mn_q=up(mn_q),
                amb_cols=up(amb_cols), w_text=up(w_text),
                w_part=None if w_part is None else up(w_part),
                window=up(window))


def legacy_scores(qdata: dict, ref_codes: torch.Tensor):
    """(B, Q, 4) float32: [acgt_matches, text_matches,
    weighted_partial_matches, valid_pairs] over the trim window.  The
    three counters are exact integers; the weighted partial is the exact
    sum rounded once (see the module docstring)."""
    r = torch.where(qdata["window"][None, :], ref_codes, 0).to(torch.int32)
    bits = [(r >> i) & 1 for i in range(4)]
    pop = bits[0] + bits[1] + bits[2] + bits[3]
    pure = pop == 1
    scale = 12 // torch.clamp(pop, min=1)          # 12, 6, 4, 3

    plane = lambda t: [t[:, :, i] for i in range(4)]
    s_aa = exact_dot([b * pure for b in bits], plane(qdata["a_q"]))
    s_vv = exact_dot([r != 0], [qdata["v_q"]])
    mw = exact_dot([b * scale for b in bits], plane(qdata["mn_q"]),
                   max_term=PARTIAL_SCALE)
    corr_t = 0
    if qdata["amb_cols"].shape[0]:
        ra = r.index_select(1, qdata["amb_cols"].long())
        corr_t = _one_hot_dot(ra, qdata["w_text"])
        if qdata.get("w_part") is not None:
            mw = mw + _one_hot_dot(ra, qdata["w_part"],
                                   max_term=PARTIAL_SCALE)
    text = s_aa + corr_t
    return torch.stack(
        [s_aa.to(torch.float32), text.to(torch.float32),
         (mw.to(torch.float64) / PARTIAL_SCALE).to(torch.float32),
         s_vv.to(torch.float32)], dim=-1)
