"""The scan on PyTorch: device data, exact six-score scoring (full
and --acgt mode), the running per-query top-k, the lossless prune
prefilter and the per-batch steps — the counterpart of
``uvaia_tpu/ops/scan.py``.

Plain tensor functions on an explicit device.  The integer scoring
passes go through the hand-written kernels (ops/score_kernels.py,
ops/recon.py) on CUDA tensors and through their plain versions on CPU
tensors; everything else here is ordinary torch ops, as the JAX
package left it to XLA.  All values are int32 counts and indices, so
every result equals the JAX package's exactly.

Scores (per reference r, query q; full mode):
  s0 ACGT matches       = acgt_c + aa
  s1 text matches       = text_c + aa + corr_t
  s2 partial matches    = part_c + mm + corr_p
  s3 valid pairs        = valid_c + vv
  s4 ACGT matches unique = aa
  s5 valid ref sites
Scores in --acgt mode (ACGT differences only; nearest.c:443-477):
  s0 ACGT matches           = (va_c - mm_c) + aa
  s1 valid ACGT comparisons = va_c + pp
  s2 ACGT matches unique    = aa
  s3 valid ref sites
  s4 dist_consensus         = mm_c + mismatches over idx_m
  s5 dist_unique            = mismatches over the polymorphic idx
Ranking is lexicographic over (s0..s5), ties to the lower database
index (first seen).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core.encoding import IS_AMBIG, IS_PURE
from .host import IDX_SENTINEL, INT32_MIN, KEY_SHIFT, _pad_to, majority_code
from .recon import delta_rebuild
from .score_kernels import (acgt_counters, acgt_counters_packed, amb_corr,
                            exact_counts, score_counters,
                            score_counters_packed, unpack_codes)

_SENT = int(IDX_SENTINEL)


@dataclass
class QueryDeviceData:
    """Per-run query data as tensors on one device.

    Site classes are realised by zeroing the query-side arrays outside
    each class (a zero code counts nothing), so reference rows are used
    full width (W = n_sites padded to a multiple of 1024 x the site
    shards)."""

    acgt: bool
    n_query: int
    n_sites: int
    k: int
    pack_keys: bool               # six scores fit 3 packed int32 keys
    cons_full: torch.Tensor       # (W,) uint8 consensus, 0 outside idx_c
    q_full: torch.Tensor          # (Q, W) uint8, 0 outside idx_mq
    amb_sites: torch.Tensor | None = None  # (A,) int32 ambiguity columns,
                                           # padded to 8 with 1 << 30
    q_poly: torch.Tensor | None = None     # --acgt: (Q, W) uint8, 0
                                           # outside the polymorphic idx
    # prune prefilter data (build_prune_data)
    u_base: torch.Tensor | None = None     # (W,) uint8 unanimous base
    q_pure_u: torch.Tensor | None = None   # (Q, W) int8 query-pure on U
    idx_p: torch.Tensor | None = None      # (P,) int32 segregating sites
    pure_p_q: torch.Tensor | None = None   # (Q,) int32
    amb_tot_q: torch.Tensor | None = None  # (Q,) int32
    delta_base: torch.Tensor | None = None  # (L,) uint8 delta base

    @property
    def device(self) -> torch.device:
        return self.q_full.device

    @property
    def width(self) -> int:
        return int(self.q_full.shape[1])


_META = ("acgt", "n_query", "n_sites", "k", "pack_keys")
_ARRAYS = tuple(f.name for f in fields(QueryDeviceData)
                if f.name not in _META)


def _to_dev(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A streamed host array (codes, delta entries, flags) as a tensor on
    `device`, without a copy where the array allows it."""
    if x.dtype == np.uint32:      # Python-encoder positions, L >= 2**16
        x = x.astype(np.int32)
    if not x.flags.writeable:     # store payloads are mmap views
        x = x.copy()
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def device_data_from_numpy(d: dict, device) -> QueryDeviceData:
    """The port's QueryDeviceData from the JAX package's fields as
    numpy arrays (``np.asarray`` of each data field of
    ``uvaia_tpu.ops.scan.QueryDeviceData``, plus its meta fields).

    ``w_part``/``w_text`` (the XLA correction tables; the correction
    kernel works from the codes) are not used by the port and are
    ignored."""
    kw = {m: d[m] for m in _META}
    for name in _ARRAYS:
        v = d.get(name)
        kw[name] = None if v is None else _to_dev(np.asarray(v), device)
    return QueryDeviceData(**kw)


def build_device_data(pack, k: int, device="cpu", site_shards: int = 1,
                      delta_base=None) -> QueryDeviceData:
    """Query tensors for a QueryPack (the numpy preparation of
    uvaia_tpu.ops.scan.build_device_data).  ``site_shards`` pads the
    site axis to a multiple of 1024 * site_shards, so that it splits
    into equal blocks over the site axis of a mesh (parallel/mesh.py).
    An --acgt pack has no ambiguity columns (no corrections in that
    mode) and a q_poly.  ``delta_base``: the sparse deltas' base
    (default: the queries' majority code)."""
    L = pack.n_sites
    mult = 1024 * site_shards
    W = -(-L // mult) * mult
    idx_mq = pack.idx_mq.astype(np.int32)
    q_full = np.zeros((pack.n_query, W), dtype=np.uint8)
    q_full[:, idx_mq] = pack.codes[:, idx_mq]
    idx_c = pack.idx_c.astype(np.int32)
    cons_full = np.zeros(W, dtype=np.uint8)
    cons_full[idx_c] = pack.consensus[idx_c]
    amb_sites = q_poly = None
    if pack.acgt:
        ip = pack.idx.astype(np.int32)
        q_poly = np.zeros((pack.n_query, W), dtype=np.uint8)
        q_poly[:, ip] = pack.codes[:, ip]
    else:
        amb_cols = np.nonzero(
            (IS_AMBIG[pack.codes[:, idx_mq]] != 0).any(axis=0))[0]
        if len(amb_cols):
            amb_sites = _pad_to(idx_mq[amb_cols], 8, value=1 << 30)
    return device_data_from_numpy(dict(
        acgt=pack.acgt, n_query=pack.n_query, n_sites=L, k=k,
        pack_keys=L < 2**15, cons_full=cons_full, q_full=q_full,
        amb_sites=amb_sites, q_poly=q_poly,
        delta_base=(majority_code(pack.codes) if delta_base is None
                    else delta_base)), device)


def build_prune_data(qd: QueryDeviceData, pack) -> None:
    """Attach the prefilter tensors to qd (see prune_step).

    U = window sites where every pure-base query agrees (on base b_i);
    P = window sites where pure queries disagree.  At U sites the ACGT
    match count is exactly [q_i pure] * [r_i == b_i]."""
    Q, L = pack.codes.shape
    W = qd.width
    t = pack.trim
    window = np.zeros(L, dtype=bool)
    window[t:L - t if t else L] = True

    pure = (IS_PURE[pack.codes] != 0) & window[None, :]
    c = pack.codes.astype(np.int16)
    pmax = np.where(pure, c, -1).max(axis=0)
    pmin = np.where(pure, c, 99).min(axis=0)
    any_pure = pure.any(axis=0)
    seg = any_pure & (pmax != pmin)               # acgt-segregating
    u_base = np.where(any_pure & ~seg, pmax, 0).astype(np.uint8)

    q_pure_u = (pure & ~seg[None, :]).astype(np.int8)
    idx_p = np.nonzero(seg)[0].astype(np.int32)
    pure_p_q = pure[:, idx_p].sum(axis=1).astype(np.int32)
    amb = ((pack.codes != 0) & (IS_PURE[pack.codes] == 0)
           & window[None, :])
    dev = qd.device
    qd.u_base = _to_dev(np.pad(u_base, (0, W - L)), dev)
    qd.q_pure_u = _to_dev(np.pad(q_pure_u, ((0, 0), (0, W - L))), dev)
    # padded with index 0, as the JAX package does: the pad columns only
    # loosen the bound, and equal survive masks need the same bound
    qd.idx_p = _to_dev(_pad_to(idx_p, 8), dev)
    qd.pure_p_q = _to_dev(pure_p_q, dev)
    qd.amb_tot_q = _to_dev(amb.sum(axis=1).astype(np.int32), dev)


# ----------------------------------------------------------------------
# scoring


def _to_width(ref_codes: torch.Tensor, w: int) -> torch.Tensor:
    """Zero-pad (or slice) the site axis to width `w`, contiguous."""
    L = ref_codes.shape[1]
    if L > w:
        ref_codes = ref_codes[:, :w]
    elif L < w:
        ref_codes = torch.nn.functional.pad(ref_codes, (0, w - L))
    return ref_codes.contiguous()


def _take_fill(x: torch.Tensor, sites: torch.Tensor) -> torch.Tensor:
    """x[:, sites] with out-of-range sites reading 0 (jnp.take's
    mode="fill"); the out-of-range pad index is never used to index."""
    inb = sites < x.shape[1]
    out = x.index_select(1, torch.where(inb, sites, 0))
    return out.masked_fill_(~inb[None, :], 0)


def _pure(c: torch.Tensor) -> torch.Tensor:
    c = c.to(torch.int32)
    return (c != 0) & ((c & (c - 1)) == 0)


def site_partials(acgt: bool, cons_full, q_full, ref_codes, q_poly=None):
    """Site-summable counters, all int32: (cons5 (B, 5), mats), mats
    (aa, mm, vv) (B, Q) in full mode and (pp, aa, ppp, aap) in --acgt
    mode, whose cons5 is (mm_c, va_c, 0, 0, valid_sites).  ``ref_codes``
    must already be q_full's width.  Every query count goes to the
    kernel (the JAX package's Q > 64 crossover to XLA was the TPU's)."""
    if acgt:
        *mats, cons5 = acgt_counters(ref_codes, q_full, q_poly, cons_full)
    else:
        *mats, cons5 = score_counters(ref_codes, q_full, cons_full)
    return cons5, tuple(mats)


def assemble_score_planes(qd: QueryDeviceData, ref_codes, cons5, mats,
                          ref_amb=None, q_amb=None):
    """Partials + ambiguity corrections -> six (B, Q) int32 planes.

    ``ref_codes`` is read only at qd.amb_sites; ``ref_amb`` — the (B, A)
    amb-column reference codes already gathered (packed scoring) —
    replaces it when given, and ``q_amb`` — the (Q, A) query codes there,
    gathered once from the full-width q_full (the mesh's site shards
    hold only a block of it) — replaces the gather from qd.q_full."""
    if qd.acgt:
        # the s4/s5 split of nearest.c:443-477
        mm_c, va_c, _, _, valid_sites = cons5.unbind(1)
        s_pp, s_aa, s_ppp, s_aap = mats
        mm_poly = s_ppp - s_aap                 # mismatches over idx alone
        mm_m = (s_pp - s_aa) - mm_poly          # mismatches over idx_m
        return ((va_c - mm_c)[:, None] + s_aa, va_c[:, None] + s_pp, s_aa,
                valid_sites[:, None].expand_as(s_aa), mm_c[:, None] + mm_m,
                mm_poly)
    acgt_c, text_c, part_c, valid_c, valid_sites = cons5.unbind(1)
    s_aa, s_mm, s_vv = mats
    corr_t = corr_p = 0
    if qd.amb_sites is not None:
        ra = ref_amb if ref_amb is not None else _take_fill(
            ref_codes, qd.amb_sites)
        qa = q_amb if q_amb is not None else _take_fill(qd.q_full,
                                                        qd.amb_sites)
        corr_t, corr_p = amb_corr(ra, qa)
    s0 = acgt_c[:, None] + s_aa
    s1 = text_c[:, None] + s_aa + corr_t
    s2 = part_c[:, None] + s_mm + corr_p
    s3 = valid_c[:, None] + s_vv
    s4 = s_aa
    s5 = valid_sites[:, None].expand_as(s_aa)
    return (s0, s1, s2, s3, s4, s5)


def assemble_scores(qd: QueryDeviceData, ref_codes, cons5, mats,
                    q_amb=None) -> torch.Tensor:
    """Stacked (B, Q, 6) form of assemble_score_planes (the mesh's
    per-shard candidate selection)."""
    return torch.stack(assemble_score_planes(qd, ref_codes, cons5, mats,
                                             q_amb=q_amb), dim=-1)


def _valid(qd: QueryDeviceData, planes) -> torch.Tensor:
    """Per-ref valid-site counts: plane 5 in full mode, 3 in --acgt."""
    return planes[3 if qd.acgt else 5][:, 0]


def score_batch_planes(qd: QueryDeviceData, ref_codes: torch.Tensor):
    """Six (B, Q) int32 score planes + per-ref valid-site counts."""
    rc = _to_width(ref_codes, qd.width)
    cons5, mats = site_partials(qd.acgt, qd.cons_full, qd.q_full, rc,
                                qd.q_poly)
    planes = assemble_score_planes(qd, rc, cons5, mats)
    return planes, _valid(qd, planes)


def gather_packed_nibbles(packed: torch.Tensor,
                          sites: torch.Tensor) -> torch.Tensor:
    """(B, P) packed bytes x (A,) site indices -> (B, A) uint8 codes
    (even site in the high nibble); out-of-range sites read code 0."""
    byte = _take_fill(packed, sites // 2)
    even = (sites % 2 == 0)[None, :]
    return torch.where(even, (byte >> 4) & 0xF, byte & 0xF)


def score_batch_planes_packed(qd: QueryDeviceData, packed: torch.Tensor):
    """score_batch_planes straight from 4-bit packed rows: the full
    (B, W) code matrix is never built."""
    packed = packed.contiguous()
    ref_amb = None
    if qd.acgt:
        *mats, cons5 = acgt_counters_packed(packed, qd.q_full, qd.q_poly,
                                            qd.cons_full)
    else:
        *mats, cons5 = score_counters_packed(packed, qd.q_full,
                                             qd.cons_full)
        if qd.amb_sites is not None:
            ref_amb = gather_packed_nibbles(packed, qd.amb_sites)
    planes = assemble_score_planes(qd, None, cons5, mats, ref_amb=ref_amb)
    return planes, _valid(qd, planes)


def unpack_codes(packed: torch.Tensor, n_sites: int) -> torch.Tensor:
    """Device-side inverse of host.pack_codes: (B, P) uint8 -> (B,
    n_sites) 4-bit codes, the high nibble first."""
    both = torch.stack([(packed >> 4) & 0xF, packed & 0xF], dim=-1)
    return both.reshape(packed.shape[0], -1)[:, :n_sites]


def reconstruct_delta(base: torch.Tensor, pos: torch.Tensor,
                      val: torch.Tensor, width: int | None = None
                      ) -> torch.Tensor:
    """Device-side inverse of host.delta_encode: (B, width) uint8 codes
    (the rebuild kernel, with the zero-run unmask fused in)."""
    return delta_rebuild(pos, val, base, width)


# ----------------------------------------------------------------------
# top-k state + merge


def init_state(n_query: int, k: int, device="cpu"):
    """(scores (Q, k, 6), idx (Q, k)): the sentinel-filled top-k state."""
    return (torch.full((n_query, k, 6), -1, dtype=torch.int32,
                       device=device),
            torch.full((n_query, k), _SENT, dtype=torch.int32,
                       device=device))


def _key_planes(qd: QueryDeviceData, planes) -> list:
    """Six score planes -> the int32 sort-key planes: three packed keys
    (s0 * KEY_SHIFT + s1, ...) when qd.pack_keys, else the six scores."""
    p = [x.to(torch.int32) for x in planes]
    if qd.pack_keys:
        return [p[0] * KEY_SHIFT + p[1], p[2] * KEY_SHIFT + p[3],
                p[4] * KEY_SHIFT + p[5]]
    return p


def _keys(qd: QueryDeviceData, scores: torch.Tensor) -> torch.Tensor:
    """Stacked form of _key_planes: (..., 6) -> (..., nk)."""
    return torch.stack(_key_planes(qd, scores.unbind(-1)), dim=-1)


def _lex_gt_planes(a: list, b: list) -> torch.Tensor:
    """Lexicographic a > b over parallel per-key plane lists."""
    nk = len(a)
    out = a[nk - 1] > b[nk - 1]
    for i in range(nk - 2, -1, -1):
        out = (a[i] > b[i]) | ((a[i] == b[i]) & out)
    return out


def select_topk(qd: QueryDeviceData, scores, idx, k: int):
    """Exact lexicographic top-k along axis 1.

    scores (Q, N, 6), idx (Q, N) -> (Q, k, 6), (Q, k); sentinel-idx
    entries sort last; ties go to the lower database index, then to the
    earlier position.  ``lax.sort(num_keys=nk + 1)`` becomes stable
    sorts from the least significant key to the most significant, the
    identity permutation making position the final tie-break."""
    neg = -_keys(qd, scores)
    neg = torch.where((idx == _SENT)[..., None], 2**31 - 1, neg)
    Q, N = idx.shape
    perm = torch.arange(N, device=idx.device).expand(Q, N)
    for key in [idx] + [neg[..., i] for i in range(neg.shape[-1] - 1,
                                                    -1, -1)]:
        _, order = torch.sort(key.gather(1, perm), dim=1, stable=True)
        perm = perm.gather(1, order)
    top = perm[:, :k]
    return (scores.gather(1, top[..., None].expand(Q, k, scores.shape[-1])),
            idx.gather(1, top))


def batch_flags_and_idx(qd, state, planes, ok, base_idx, ref_idx=None):
    """is_best flags (would this row enter any query's current top-k?)
    and the rows' global database indices (``ref_idx`` for a compacted
    batch, else base_idx + row)."""
    st_scores = state[0]
    cand = [torch.where(ok[:, None], key, int(INT32_MIN))
            for key in _key_planes(qd, planes)]
    thr = _keys(qd, st_scores[:, qd.k - 1, :])          # (Q, nk)
    gt = _lex_gt_planes(cand, [thr[None, :, i] for i in range(len(cand))])
    is_best = gt.any(dim=1) & ok
    if ref_idx is None:
        ref_idx = base_idx + torch.arange(planes[0].shape[0],
                                          dtype=torch.int32,
                                          device=ok.device)
    return is_best, torch.where(ok, ref_idx, _SENT)


def merge_topk(qd: QueryDeviceData, state, planes, ok, base_idx,
               ref_idx=None):
    """Merge a scored batch (six (B, Q) planes) into the running top-k.
    Returns (new_state, is_best (B,) bool).

    INVARIANT: rows must arrive in ascending global-index order across
    calls (every caller streams the database forward).  The skip when
    no row beats a k-th threshold rejects a candidate that only TIES
    the threshold; under ascending order that candidate would also lose
    select_topk's first-seen tie-break, so the skip is exact.  The
    C-row candidate window keeps ascending batch order, so it is exact
    under the same invariant.

    The two branch predicates of the JAX version (``lax.cond``) are one
    host read of the flagged-row count here: a device sync per step."""
    st_scores, st_idx = state
    B = planes[0].shape[0]
    is_best, batch_idx = batch_flags_and_idx(qd, state, planes, ok,
                                             base_idx, ref_idx)
    n_best = int(is_best.sum())
    if n_best == 0:
        return state, is_best
    C = min(256, B)
    if C == B or n_best > C:
        all_scores = torch.cat(
            [st_scores, torch.stack([p.T for p in planes], dim=-1)], dim=1)
        all_idx = torch.cat(
            [st_idx, batch_idx[None, :].expand(qd.n_query, B)], dim=1)
    else:
        # candidate window: the <= C flagged rows, in ascending batch
        # order (value B - row), the rest as sentinel slots
        rows = torch.arange(B, dtype=torch.int32, device=ok.device)
        sel_val, sel_pos = torch.topk(torch.where(is_best, B - rows, 0), C)
        sel_ok = sel_val > 0
        cand_idx = torch.where(sel_ok, batch_idx[sel_pos], _SENT)
        cand_scores = torch.stack(
            [torch.where(sel_ok[:, None], p[sel_pos], -1) for p in planes],
            dim=-1)                                    # (C, Q, 6)
        all_scores = torch.cat([st_scores, cand_scores.transpose(0, 1)],
                               dim=1)
        all_idx = torch.cat(
            [st_idx, cand_idx[None, :].expand(qd.n_query, C)], dim=1)
    return select_topk(qd, all_scores, all_idx, qd.k), is_best


# ----------------------------------------------------------------------
# steps


def scan_step(qd: QueryDeviceData, state, ref_codes, ok, base_idx):
    """One database batch of codes: score + merge -> (state, is_best)."""
    planes, _ = score_batch_planes(qd, ref_codes)
    return merge_topk(qd, state, planes, ok, base_idx)


def scan_step_packed(qd: QueryDeviceData, state, packed, ok, base_idx):
    """scan_step on 4-bit packed rows (host.pack_codes)."""
    planes, _ = score_batch_planes_packed(qd, packed)
    return merge_topk(qd, state, planes, ok, base_idx)


def scan_step_delta(qd: QueryDeviceData, state, pos, val, ok, base_idx):
    """scan_step on a sparse-delta upload (host.delta_encode)."""
    ref = reconstruct_delta(qd.delta_base, pos, val, width=qd.width)
    planes, _ = score_batch_planes(qd, ref)
    return merge_topk(qd, state, planes, ok, base_idx)


# ----------------------------------------------------------------------
# two-phase pruned scan: a sound per-pair upper bound on the leading
# sort key lets most references skip the exact scoring.  A reference is
# pruned only when its best possible key is strictly below every
# query's current k-th threshold, so nothing that could enter the
# output is dropped.


def prune_step(qd: QueryDeviceData, state, ref_codes, ok):
    """Phase 1: (B,) survivor mask (requires build_prune_data).

      s0(r, q) = sum_U [q_i pure][r_i == b_i]   (exact, one product)
               + s0_P                           (<= min pure counts on P)
      s1(r, q) <= s0_ub + min(amb_r, amb_q)     (full mode: text matches)
      s1(r, q) <= min(pure_r, pure_q) totals    (--acgt: valid acgt pairs)

    A reference survives iff its packed key-1 upper bound reaches some
    query's current k-th threshold key."""
    rc = _to_width(ref_codes, int(qd.u_base.shape[0]))
    pure_r = _pure(rc)                                        # (B, W)
    r_match = (rc == qd.u_base[None, :]) & (qd.u_base != 0)[None, :]
    s0_u = exact_counts(r_match, qd.q_pure_u)                 # (B, Q)
    pure_p_r = pure_r.index_select(1, qd.idx_p).sum(dim=1,
                                                    dtype=torch.int32)
    s0_ub = s0_u + torch.minimum(pure_p_r[:, None], qd.pure_p_q[None, :])
    if qd.acgt:
        pure_tot_r = pure_r.sum(dim=1, dtype=torch.int32)
        pure_tot_q = qd.pure_p_q + qd.q_pure_u.sum(dim=1, dtype=torch.int32)
        s1_ub = torch.minimum(pure_tot_r[:, None], pure_tot_q[None, :])
    else:
        amb_r = ((rc != 0) & ~pure_r).sum(dim=1, dtype=torch.int32)
        s1_ub = s0_ub + torch.minimum(amb_r[:, None], qd.amb_tot_q[None, :])
    key1_ub = s0_ub * KEY_SHIFT + s1_ub if qd.pack_keys else s0_ub
    thr = _keys(qd, state[0][:, qd.k - 1, :])[..., 0]         # (Q,)
    return ok & (key1_ub >= thr[None, :]).any(dim=1)


def prune_and_hold(qd: QueryDeviceData, state, packed, ok):
    """Phase 1 on packed rows -> (survive, unpacked codes at the full
    width, kept on the device so phase 2 never re-uploads)."""
    ref_codes = _to_width(unpack_codes(packed, qd.n_sites), qd.width)
    return prune_step(qd, state, ref_codes, ok), ref_codes


def prune_and_hold_delta(qd: QueryDeviceData, state, pos, val, ok):
    """prune_and_hold on a sparse-delta upload."""
    ref_codes = reconstruct_delta(qd.delta_base, pos, val, width=qd.width)
    return prune_step(qd, state, ref_codes, ok), ref_codes


def new_survivor_buffer(cap: int, width: int, device):
    """(buf, buf_idx, buf_n) for accumulate_survivors: ``cap`` rows plus
    one spill row that takes the writes of non-surviving rows (the JAX
    package drops them with an out-of-range scatter; torch refuses an
    out-of-range index)."""
    return (torch.zeros((cap + 1, width), dtype=torch.uint8, device=device),
            torch.full((cap + 1,), _SENT, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def accumulate_survivors(buf, buf_idx, buf_n, ref_codes, survive,
                         base_idx, ref_idx=None):
    """Append this batch's surviving rows to the device survivor buffer
    in stream order, with no host round trip.  Updates buf, buf_idx and
    buf_n in place (the JAX version donated them); the caller keeps
    buf_n + B <= capacity by flushing first.  The rows' global indices
    are base_idx + row, or ``ref_idx`` (B,) int32 where given."""
    cap = buf.shape[0] - 1
    s32 = survive.to(torch.int32)
    pos = buf_n + torch.cumsum(s32, 0, dtype=torch.int32) - s32
    pos_w = torch.where(survive & (pos < cap), pos, cap).long()
    buf.index_copy_(0, pos_w, ref_codes)
    gidx = ref_idx if ref_idx is not None else base_idx + torch.arange(
        ref_codes.shape[0], dtype=torch.int32, device=buf.device)
    buf_idx.index_copy_(0, pos_w, gidx)
    buf_n += s32.sum(dtype=torch.int32)
    return buf, buf_idx, buf_n


def flush_survivors(qd: QueryDeviceData, state, buf, buf_idx, buf_n):
    """Phase 2 over the survivor buffer (slots >= buf_n masked).
    accumulate_survivors appends in stream order, so the buffer's
    indices ascend and merge_topk's invariant holds."""
    cap = buf.shape[0] - 1
    ok = torch.arange(cap, dtype=torch.int32, device=buf.device) < buf_n
    return scan_step_gather(qd, state, buf[:cap], ok, buf_idx[:cap])


def scan_step_gather(qd: QueryDeviceData, state, ref_codes, ok, ref_idx):
    """Phase 2: scan_step for a compacted survivor batch with explicit
    global indices, which must ascend within the batch and across
    calls (merge_topk's invariant)."""
    planes, _ = score_batch_planes(qd, ref_codes)
    return merge_topk(qd, state, planes, ok, 0, ref_idx=ref_idx)
