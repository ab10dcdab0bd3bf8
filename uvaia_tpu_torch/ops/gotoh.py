"""Batched banded global alignment with affine gaps, on PyTorch.

The counterpart of ``uvaia_tpu/ops/gotoh.py``.  Two halves:

* host (numpy, jax-free): byte-identical copies of ``decode_events``,
  ``unpack_meta_events``, ``certify``, ``unpack_meta`` and the cost
  constants — ``uvaia_tpu/ops/gotoh.py`` imports jax, which the GPU
  machine does not have;
* device (torch ops): the traceback walks, the sparse output encoding
  and the group aligners around the forward DP of
  :mod:`.gotoh_kernels`.  These were XLA ops in the JAX package, not
  Pallas kernels: ``lax.while_loop`` is a Python ``while`` that reads
  ``any(active)`` on the host each iteration, a dropping scatter
  (``.at[].set(mode="drop")``) writes into a spill column that is
  sliced off, and clipped gathers use clamped indices.

Cost model (minimisation): match 0, mismatch 4, gap of length g costs
6 + 2g.  Characters are raw ASCII bytes ('N' vs 'A' is a mismatch).
"""

from __future__ import annotations

import numpy as np
import torch

INF = 1 << 28
MISMATCH = 4
GAP_OPEN = 6
GAP_EXT = 2
OE = GAP_OPEN + GAP_EXT
EV_CAP = 192     # default event-checkpoint capacity per row

# ----------------------------------------------------------------------
# host half (copies of uvaia_tpu.ops.gotoh)


def decode_events(q: np.ndarray, ref: np.ndarray, t_end: int, lo: int,
                  ev_i: np.ndarray, ev_t: np.ndarray, cnt: int):
    """Host-side inverse of gotoh_traceback_events: rebuild the
    ref-projected row and the walked path's cost from the checkpoint
    chain.  The segment kind between consecutive checkpoints is
    implied by the deltas (M: di>0, dt=0; X: dt=di>0; Y: di=0, dt<0).

    Recomputing the cost here (mismatch count over M segments + affine
    gap terms) and checking it against the DP score replaces the dense
    walk's device-side cost accumulator — it validates the DECODED
    OUTPUT end-to-end, so a corrupt traceback or decode cannot pass.

    Returns (row (n,) uint8, cost int) or (None, -1) if malformed.
    """
    n = ref.shape[0]
    out = np.empty(n, dtype=np.uint8)
    i, t = n, int(t_end)
    cost = 0
    chain = [(int(ev_i[k]), int(ev_t[k])) for k in range(cnt)]
    chain.append((0, -lo))
    for i2, t2 in chain:
        di = i - i2
        dt = t2 - t
        if di > 0 and dt == 0:        # M segment: rows (i2, i]
            s = t + lo
            if i2 + s < 0:
                return None, -1
            seg = q[i2 + s: i + s]
            if seg.shape[0] != di:
                return None, -1
            out[i2:i] = seg
            cost += MISMATCH * int(np.count_nonzero(seg != ref[i2:i]))
        elif di > 0 and dt == di:     # X (deletion) run
            out[i2:i] = ord("-")
            cost += GAP_OPEN + GAP_EXT * di
        elif di == 0 and dt < 0:      # Y (insertion) run
            cost += GAP_OPEN + GAP_EXT * (-dt)
        else:
            return None, -1
        i, t = i2, t2
    return out, cost


def unpack_meta_events(meta: np.ndarray, K: int):
    """Host-side split of the events align_rows meta buffer:
    (score, edge_min, done, cnt, overflow, t_end, ev_i (B,K),
    ev_t (B,K))."""
    return (meta[:, 0], meta[:, 1], meta[:, 2].astype(bool),
            meta[:, 3], meta[:, 4].astype(bool), meta[:, 5],
            meta[:, 6:6 + K], meta[:, 6 + K:6 + 2 * K])


def certify(score, edge_min, done, walk_cost, qlens, n, lo, width):
    """Host-side optimality certificates for a banded result.

    Certificate 1 (edge): any path that ever leaves the band crosses an
    edge diagonal (diagonals change by 1 per gap char) and then needs
    >= one gap char out and one back, costing 2*GAP_EXT beyond the edge
    cell's DP value.  If the banded score beats that, no out-of-band
    path can win.  ("The in-band optimum does not touch the edge" is
    NOT sound — a cheaper path may lie entirely outside the band.)

    Certificate 2 (wander): a path of cost c wanders at most c/(2e)
    diagonals beyond the [0, d_end] hull (out + back costs >= 2e per
    diagonal), so a band covering that hull +/- c/(2e) provably
    contains the global optimum.

    Returns (ok, consistent, wander) as numpy arrays.
    """
    score = np.asarray(score)
    gamma = np.asarray(edge_min).astype(np.int64) + 2 * GAP_EXT
    d_end = np.asarray(qlens).astype(np.int64) - n
    wander = score.astype(np.int64) // (2 * GAP_EXT) + 1
    covered = ((np.minimum(0, d_end) - wander >= lo)
               & (np.maximum(0, d_end) + wander <= lo + width - 1))
    consistent = (np.asarray(done) & (score < (1 << 27))
                  & (np.asarray(walk_cost) == score))
    ok = consistent & ((score < gamma) | covered)
    return ok, consistent, wander


def unpack_meta(meta: np.ndarray, E: int):
    """Host-side inverse of pack_outputs: (score, edge_min, done,
    walk_cost, count, pos (B,E), chars (B,E))."""
    chars = meta[:, 5 + E:].astype(np.uint32)
    chars = np.stack([(chars >> s) & 0xFF for s in (0, 8, 16, 24)],
                     axis=-1).reshape(meta.shape[0], E).astype(np.uint8)
    return (meta[:, 0], meta[:, 1], meta[:, 2].astype(bool), meta[:, 3],
            meta[:, 4], meta[:, 5:5 + E], chars)


# ----------------------------------------------------------------------
# device half (torch ops; index arithmetic in int64, results as in JAX)


def _any_active(i: torch.Tensor, t: torch.Tensor, lo: int) -> bool:
    """The while-loop condition, read on the host."""
    return bool(((i > 0) | ((i + t + lo) > 0)).any())


def gotoh_traceback(tb: torch.Tensor, ref: torch.Tensor, q: torch.Tensor,
                    t_end: torch.Tensor, lo: int, n: int):
    """Walk the packed traceback, emitting the ref-projected alignment.

    Returns (aligned (B, n) uint8 ('-' for deletions), done (B,) bool,
    band_edge (B,) bool — True if the path touched the band border,
    walk_cost (B,) int32 — the walked path's cost, for validation
    against the forward score).

    A diagonal step keeps slot t and decrements the row, so a run of M
    cells lies along tb[i-1 .. i-r, b, t]: each iteration fetches R
    bytes of that line and retires the leading M-run (up to R-1 cells)
    at once; rows whose move is a gap or boundary take one step.
    """
    B, m_pad = q.shape
    W = tb.shape[2]
    dev = tb.device
    bidx = torch.arange(B, device=dev)
    GAP = ord("-")
    refl = ref.long()
    ql = q.long()
    tb_flat = tb.reshape(-1)
    R = 32
    karr = torch.arange(R, device=dev)

    def read_src(i, t):
        return tb[torch.clamp(i - 1, 0, n - 1), bidx,
                  torch.clamp(t, 0, W - 1)].long()

    def step(carry, enable):
        i, t, mat, cur, out, edge, cost = carry
        j = i + t + lo
        active = ((i > 0) | (j > 0)) & enable
        edge = edge | (active & (i > 0) & ((t <= 0) | (t >= W - 1)))
        lead_y = active & (i == 0)                 # leading insertions
        col0_x = active & (i > 0) & (j == 0)       # leading deletions
        is_m = active & ~lead_y & ~col0_x & (mat == 0)
        is_x = (active & ~lead_y & ~col0_x & (mat == 1)) | col0_x
        is_y = (active & ~lead_y & (mat == 2)) | lead_y
        x_ext = ((cur >> 2) & 1).bool()
        y_ext = ((cur >> 3) & 1).bool()

        qc = ql[bidx, torch.clamp(j - 1, 0, m_pad - 1)]
        write = is_m | is_x
        pos = torch.where(write, i - 1, n)         # n: the spill column
        out[bidx, pos] = torch.where(is_m, qc, GAP).to(torch.uint8)

        ni = torch.where(is_m | is_x, i - 1, i)
        nt = torch.where(is_x, t + 1, torch.where(is_y, t - 1, t))
        # a Y-gap *open* came from G = min(M, X), whose argmin is bit 4
        tgt = read_src(ni, nt)
        nxt = tgt & 3
        nxt_g = (tgt >> 4) & 1
        n_mat = torch.where(
            is_m, nxt,
            torch.where(is_x, torch.where(x_ext, 1, nxt),
                        torch.where(is_y, torch.where(y_ext, 2, nxt_g),
                                    mat)))
        n_mat = torch.where(active, n_mat, mat)
        n_cur = torch.where(active, tgt, cur)
        ni = torch.where(active, ni, i)
        nt = torch.where(active, nt, t)

        refc = refl[torch.clamp(i - 1, 0, n - 1)]
        inc = torch.where(is_m, torch.where(qc == refc, 0, MISMATCH), 0)
        inc = inc + torch.where(
            is_x, GAP_EXT + torch.where(x_ext, 0, GAP_OPEN), 0)
        inc = inc + torch.where(
            is_y & ~lead_y, GAP_EXT + torch.where(y_ext, 0, GAP_OPEN), 0)
        nj = ni + nt + lo
        inc = inc + torch.where((i > 0) & (ni == 0) & (nj > 0),
                                GAP_OPEN + GAP_EXT * nj, 0)
        cost = cost + torch.where(active, inc, 0)
        return ni, nt, n_mat, n_cur, out, edge, cost

    def mega(carry):
        i, t, mat, cur, out, edge, cost = carry
        j = i + t + lo
        active = (i > 0) | (j > 0)
        can_run = active & (mat == 0) & (i > 0) & (j > 0)

        i1, t1, mat1, cur1, out, edge, cost = step(
            (i, t, mat, cur, out, edge, cost), ~can_run)

        # M-run fast path: v[k] = tb byte at row i-1-k, slot t
        rowidx = i[:, None] - 1 - karr[None, :]             # (B, R)
        flat = (torch.clamp(rowidx, 0, n - 1) * (B * W)
                + (bidx * W + torch.clamp(t, 0, W - 1))[:, None])
        v = tb_flat[flat].long()
        ok_next = torch.cat([can_run[:, None], (v[:, 1:] & 3) == 0], dim=1)
        okk = (ok_next & can_run[:, None] & (rowidx >= 0)
               & ((j[:, None] - 1 - karr[None, :]) >= 0))
        runlen = torch.clamp(torch.cumprod(okk.long(), dim=1).sum(dim=1),
                             max=R - 1)
        kmask = karr[None, :] < runlen[:, None]
        qch = ql[bidx[:, None],
                 torch.clamp(j[:, None] - 1 - karr[None, :], 0, m_pad - 1)]
        refch = refl[torch.clamp(rowidx, 0, n - 1)]
        outpos = torch.where(kmask, rowidx, n)              # n: spill
        out[bidx[:, None], outpos] = qch.to(torch.uint8)
        run_cost = torch.where(kmask & (qch != refch), MISMATCH,
                               0).sum(dim=1)
        i2 = i - runlen
        j2 = j - runlen
        run_cost = run_cost + torch.where(can_run & (i2 == 0) & (j2 > 0),
                                          GAP_OPEN + GAP_EXT * j2, 0)
        cur2 = torch.gather(v, 1, runlen[:, None])[:, 0]
        edge = edge | (can_run & ((t <= 0) | (t >= W - 1)))
        ni = torch.where(can_run, i2, i1)
        nt = torch.where(can_run, t, t1)
        nmat = torch.where(can_run, cur2 & 3, mat1)
        ncur = torch.where(can_run, cur2, cur1)
        ncost = cost + torch.where(can_run, run_cost, 0)
        return ni, nt, nmat, ncur, out, edge, ncost

    i = torch.full((B,), n, dtype=torch.long, device=dev)
    t = t_end.long()
    cur = read_src(i, t)
    carry = (i, t, cur & 3, cur,
             torch.full((B, n + 1), GAP, dtype=torch.uint8, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.long, device=dev))
    # every iteration retires >= 1 path step per active row, so the
    # cap only guards against a corrupt traceback (done=False rows)
    max_iters = n + m_pad + 2
    k = 0
    while k < max_iters and _any_active(carry[0], carry[1], lo):
        carry = mega(carry)
        k += 1
    i_f, t_f, _, _, out, edge, cost = carry
    done = (i_f == 0) & ((i_f + t_f + lo) == 0)
    return out[:, :n], done, edge, cost.to(torch.int32)


def _all_m_blocks(tb: torch.Tensor, n: int):
    """Per-256-row and per-4096-row "every cell is M-source" flags
    (n1, B, W) and (n2, B, W); a partial tail block is reduced over the
    rows it has."""
    BL1, BL2 = 256, 256 * 16
    allm1 = torch.stack([((tb[r:r + BL1] & 3) == 0).all(dim=0)
                         for r in range(0, n, BL1)])
    allm2 = torch.stack([allm1[k:k + 16].all(dim=0)
                         for k in range(0, allm1.shape[0], 16)])
    return BL1, BL2, allm1, allm2


def gotoh_traceback_events(tb: torch.Tensor, t_end: torch.Tensor, lo: int,
                           n: int, K: int):
    """Event-list traceback: O(#gap runs) instead of O(path length).

    Records only the (i, t) checkpoints where the move kind (M / X / Y)
    changes; the host rebuilds the row from the query bytes it already
    holds (decode_events).  Pure-diagonal stretches are skipped with the
    hierarchical all-M flags (one 256-row or 4096-row block per
    iteration) and a 32-byte line probe for partial blocks.

    Returns (ev_i (B,K) int32, ev_t (B,K) int32, cnt (B,) int32,
    done (B,) bool, edge (B,) bool, overflow (B,) bool).  Rows with
    overflow=True exceeded K checkpoints and must be re-walked densely.
    """
    _, B, W = tb.shape
    dev = tb.device
    bidx = torch.arange(B, device=dev)
    BL1, BL2, allm1, allm2 = _all_m_blocks(tb, n)
    n1, n2 = allm1.shape[0], allm2.shape[0]
    tb_flat = tb.reshape(-1)
    R = 32
    karr = torch.arange(R, device=dev)

    i = torch.full((B,), n, dtype=torch.long, device=dev)
    t = t_end.long()
    cur = tb[torch.clamp(i - 1, 0, n - 1), bidx,
             torch.clamp(t, 0, W - 1)].long()
    mat = cur & 3
    kprev = torch.full((B,), -1, dtype=torch.long, device=dev)
    cnt = torch.zeros(B, dtype=torch.long, device=dev)
    # column K is the spill column of the dropping scatter
    ev_i = torch.zeros((B, K + 1), dtype=torch.long, device=dev)
    ev_t = torch.zeros((B, K + 1), dtype=torch.long, device=dev)
    edge = torch.zeros(B, dtype=torch.bool, device=dev)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)

    max_iters = 2 * n + 2 * W + 8    # all-single-step worst case
    k = 0
    while k < max_iters and _any_active(i, t, lo):
        k += 1
        j = i + t + lo
        active = (i > 0) | (j > 0)
        lead_y = active & (i == 0)
        col0_x = active & (i > 0) & (j == 0)
        is_m = active & ~lead_y & ~col0_x & (mat == 0)
        is_x = (active & ~lead_y & ~col0_x & (mat == 1)) | col0_x
        is_y = (active & ~lead_y & (mat == 2)) | lead_y
        kind = torch.where(is_m, 0, torch.where(is_x, 1, 2))

        rec = active & (kprev >= 0) & (kind != kprev)
        pos = torch.where(rec & (cnt < K), cnt, K)
        ev_i[bidx, pos] = i
        ev_t[bidx, pos] = t
        ovf = ovf | (rec & (cnt >= K))
        cnt = cnt + rec.long()
        kprev = torch.where(active, kind, kprev)
        edge = edge | (active & (i > 0) & ((t <= 0) | (t >= W - 1)))

        # ---- M-skip path: retire the longest provable diagonal run
        tcl = torch.clamp(t, 0, W - 1)
        r_top = i - 1                          # topmost tb row consumed
        blk1 = torch.clamp(torch.div(r_top, BL1, rounding_mode="floor"),
                           0, n1 - 1)
        blk2 = torch.clamp(torch.div(r_top, BL2, rounding_mode="floor"),
                           0, n2 - 1)
        cand1 = torch.where(allm1[blk1, bidx, tcl], blk1 * BL1, i)
        cand2 = torch.where(allm2[blk2, bidx, tcl], blk2 * BL2, i)
        rowidx = r_top[:, None] - karr[None, :]
        flat = (torch.clamp(rowidx, 0, n - 1) * (B * W)
                + (bidx * W + tcl)[:, None])
        v = tb_flat[flat]
        okk = (rowidx >= 0) & ((v & 3) == 0)
        runlen = torch.cumprod(okk.long(), dim=1).sum(dim=1)
        cand_r = i - runlen
        i2 = torch.minimum(torch.minimum(cand1, cand2), cand_r)
        i2 = torch.maximum(i2, torch.clamp(-t - lo, min=0))  # keep j2 >= 0
        cur2 = tb_flat[torch.clamp(i2 - 1, 0, n - 1) * (B * W)
                       + bidx * W + tcl].long()
        mat2 = cur2 & 3

        # ---- classic single step for gap / boundary rows
        x_ext = ((cur >> 2) & 1).bool()
        y_ext = ((cur >> 3) & 1).bool()
        ni_c = torch.where(is_x, i - 1, i)
        nt_c = torch.where(is_x, t + 1, torch.where(is_y, t - 1, t))
        tgt = tb[torch.clamp(ni_c - 1, 0, n - 1), bidx,
                 torch.clamp(nt_c, 0, W - 1)].long()
        nxt = tgt & 3
        nxt_g = (tgt >> 4) & 1
        mat_c = torch.where(is_x, torch.where(x_ext, 1, nxt),
                            torch.where(is_y, torch.where(y_ext, 2, nxt_g),
                                        mat))

        i, t, mat, cur = (
            torch.where(is_m, i2, torch.where(active, ni_c, i)),
            torch.where(is_m, t, torch.where(active, nt_c, t)),
            torch.where(is_m, mat2, torch.where(active, mat_c, mat)),
            torch.where(is_m, cur2, torch.where(active, tgt, cur)))
    done = (i == 0) & ((i + t + lo) == 0)
    i32 = torch.int32
    return (ev_i[:, :K].to(i32), ev_t[:, :K].to(i32), cnt.to(i32), done,
            edge, ovf)


def diff_encode(aligned: torch.Tensor, ref: torch.Tensor, E: int):
    """Sparse device->host encoding of ref-projected rows: (count (B,),
    pos (B, E) int32 ascending with n as filler, chars (B, E) uint8).
    Rows with count > E must be fetched densely by the caller."""
    n = ref.shape[0]
    diff = aligned != ref[None, :]
    iota = torch.arange(n, dtype=torch.int32, device=aligned.device)
    pos = torch.where(diff, iota[None, :], n).to(torch.int32)
    pos = torch.sort(pos, dim=1).values[:, :E]
    if pos.shape[1] < E:                     # short references: pad
        pos = torch.nn.functional.pad(pos, (0, E - pos.shape[1]), value=n)
    chars = torch.gather(aligned, 1, torch.clamp(pos, 0, n - 1).long())
    return diff.sum(dim=1).to(torch.int32), pos, chars


def pack_outputs(aligned, ref, score, edge_min, done, walk_cost, E: int):
    """Every host-bound per-row output of a group in ONE int32 buffer
    (B, 5+E+E/4): [score, edge_min, done, walk_cost, diff_count,
    pos_0..pos_{E-1}, chars packed 4-per-int32]."""
    count, pos, chars = diff_encode(aligned, ref, E)
    c = chars.to(torch.int32).reshape(chars.shape[0], E // 4, 4)
    chars_packed = (c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
                    | (c[..., 3] << 24))
    col = lambda a: a.to(torch.int32)[:, None]
    return torch.cat([col(score), col(edge_min), col(done), col(walk_cost),
                      count[:, None], pos, chars_packed], dim=1)


def _gather_rows(arr_all, lens_all, idx):
    idx = idx.long()
    return arr_all.index_select(0, idx), lens_all.index_select(0, idx)


def align_rows(ref, arr_all, lens_all, idx, lo: int, width: int, K: int):
    """Group aligner (events form): row gather + forward + event-list
    traceback, fused into one int32 meta buffer (B, 6+2K): [score,
    edge_min, done, cnt, overflow, t_end, ev_i (K), ev_t (K)].  The host
    rebuilds rows from the query bytes it already holds
    (decode_events); rows with overflow=True need align_rows_dense."""
    from . import gotoh_kernels
    arr, lens = _gather_rows(arr_all, lens_all, idx)
    tb, score, t_end, edge_min = gotoh_kernels.gotoh_forward(
        ref, arr, lens, lo, width)
    ev_i, ev_t, cnt, done, _edge, ovf = gotoh_traceback_events(
        tb, t_end, lo, ref.shape[0], K)
    col = lambda a: a.to(torch.int32)[:, None]
    return torch.cat([col(score), col(edge_min), col(done), col(cnt),
                      col(ovf), col(t_end), ev_i, ev_t], dim=1)


def align_rows_dense(ref, arr_all, lens_all, idx, lo: int, width: int,
                     E: int):
    """Dense-walk group aligner: forward + per-character traceback +
    fused output packing; the fallback for event-capacity overflow
    rows.  Returns (meta, aligned): `aligned` stays on the device for
    dense-fetch rows (diff count > E)."""
    from . import gotoh_kernels
    arr, lens = _gather_rows(arr_all, lens_all, idx)
    tb, score, t_end, edge_min = gotoh_kernels.gotoh_forward(
        ref, arr, lens, lo, width)
    aligned, done, _edge, walk_cost = gotoh_traceback(
        tb, ref, arr, t_end, lo, ref.shape[0])
    meta = pack_outputs(aligned, ref, score, edge_min, done, walk_cost, E)
    return meta, aligned


def align_batch(ref: np.ndarray, queries: np.ndarray, qlens: np.ndarray,
                lo: int, width: int, device="cpu"):
    """Host wrapper: forward + event traceback + host decode on
    `device`.  Returns (aligned (B, n) uint8, score (B,), ok (B,) —
    provably-optimal-and-consistent flag, consistent (B,), wander
    (B,))."""
    from . import gotoh_kernels
    n = ref.shape[0]
    up = lambda a, dt=None: torch.from_numpy(
        np.require(a, dtype=dt, requirements="CW")).to(device)
    ref_d, q_d = up(ref), up(queries)
    tb, score, t_end, edge_min = gotoh_kernels.gotoh_forward(
        ref_d, q_d, up(qlens, np.int32), lo, width)
    ev_i, ev_t, cnt, done, _edge, ovf = gotoh_traceback_events(
        tb, t_end, lo, n, EV_CAP)
    ev_i, ev_t, cnt, done, ovf, t_end_h = (
        a.cpu().numpy() for a in (ev_i, ev_t, cnt, done, ovf, t_end))
    B = queries.shape[0]
    aligned = np.zeros((B, n), dtype=np.uint8)
    walk_cost = np.full(B, -1, dtype=np.int64)
    decoded = np.zeros(B, dtype=bool)
    for b in range(B):
        if ovf[b] or not done[b]:
            continue
        row, cost = decode_events(queries[b], ref, t_end_h[b], lo,
                                  ev_i[b], ev_t[b], int(cnt[b]))
        if row is not None:
            aligned[b] = row
            walk_cost[b] = cost
            decoded[b] = True
    fallback = done & ~decoded
    if fallback.any():
        # event-capacity overflow / decode failure: dense per-character
        # walk for those rows (same fallback _collect_group uses)
        al_d, done_d, _edge, wc_d = gotoh_traceback(
            tb, ref_d, q_d, t_end, lo, n)
        al_d, done_d, wc_d = (a.cpu().numpy() for a in (al_d, done_d, wc_d))
        for b in np.nonzero(fallback & done_d)[0]:
            aligned[b] = al_d[b, :n]
            walk_cost[b] = wc_d[b]
            decoded[b] = True
    score = score.cpu().numpy()
    ok, consistent, wander = certify(score, edge_min.cpu().numpy(),
                                     done & decoded, walk_cost, qlens, n,
                                     lo, width)
    return aligned, score, ok, consistent, wander
