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
  ``any(active)`` on the host every few iterations (and, on a CUDA
  device, replays one captured iteration from a CUDA graph), a dropping
  scatter (``.at[].set(mode="drop")``) writes into a spill column that
  is sliced off, and clipped gathers use clamped indices.  The walks
  visit the cells of the JAX package's walks but retire whole runs of
  them an iteration (M, X and Y runs by a line probe, the leading
  insertion and column 0 in closed form); every output is equal.

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


# The walks' loop condition is read on the host once every
# HOST_READ_EVERY iterations: an iteration on a batch with no active
# row changes nothing (every update is masked by `active`, every
# scatter of an idle row lands in a spill column).
HOST_READ_EVERY = 8
# cells of a run (M, X or Y) fetched and retired in one iteration: the
# events walk skips whole all-M blocks besides; the dense walk writes
# every M cell, so its probe alone sets its iteration count
PROBE = 128
DENSE_PROBE = 256
# totals over every walk since import: loop iterations and host reads
walk_counts = {"iterations": 0, "host_reads": 0}
# one memory pool for the graphs, one after another; the allocator keeps
# a pool only while a graph uses it, so the newest graph is held until
# the next one is captured
_graph_pool = None
_last_graph = None
_graph_streams = {}       # device index -> the capture stream


def _any_active(i: torch.Tensor, t: torch.Tensor, lo: int) -> bool:
    """The while-loop condition, read on the host."""
    walk_counts["host_reads"] += 1
    return bool(((i > 0) | ((i + t + lo) > 0)).any())


def _walk(body, carry, lo: int, max_iters: int):
    """``while k < max_iters and any(active): carry = body(carry)`` with
    the condition read every HOST_READ_EVERY iterations; carry[0] and
    carry[1] are the row and slot of every walker.

    On a CUDA device one iteration (~100 small launches, which the host
    sends more slowly than the card runs them) is captured once in a
    CUDA graph that updates the carry in place and is replayed; on the
    CPU the body runs as it is."""
    step = None
    k = 0
    while k < max_iters and _any_active(carry[0], carry[1], lo):
        if step is None and carry[0].is_cuda:
            step = _capture_step(body, carry)
        for _ in range(min(HOST_READ_EVERY, max_iters - k)):
            if step is None:
                carry = body(carry)
            else:
                step.replay()
            k += 1
    walk_counts["iterations"] += k
    return carry


def _capture_step(body, carry):
    """One iteration of `body` as a CUDA graph writing its results back
    into the carry's own tensors, which the next replay reads."""
    global _graph_pool, _last_graph
    if _graph_pool is None:
        _graph_pool = torch.cuda.graph_pool_handle()
    dev = carry[0].device
    side = _graph_streams.get(dev.index)
    if side is None:
        side = _graph_streams[dev.index] = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(pool=_graph_pool)
        try:
            for old, new in zip(carry, body(carry), strict=True):
                if new is not old:
                    old.copy_(new)
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    _last_graph = graph
    return graph


class _Walker:
    """What both walks share: the move kinds of a state, a line probe
    of `probe` cells along a run's direction and the length of the run.

    A state (i, t) with j = i + t + lo sits on tb byte tb[i-1, b, t]
    (`cur`).  Its kind: leading insertions (i == 0) and leading
    deletions (j == 0) are closed-form runs to the origin; elsewhere
    mat 0 / 1 / 2 is an M / X / Y move.  An M run keeps t and descends
    the rows while the next byte's source is M; an X run descends the
    rows at rising t while bit 2 (x_ext) of the byte it leaves is set;
    a Y run stays in its row at falling t while bit 3 (y_ext) is set.
    All reads clamp row and slot, as the single-step walk's did.
    """

    def __init__(self, tb: torch.Tensor, lo: int, n: int, probe: int):
        _, self.B, self.W = tb.shape
        self.lo, self.n = lo, n
        self.tb_flat = tb.reshape(-1)
        self.bidx = torch.arange(self.B, device=tb.device)
        self.base = self.bidx * self.W
        self.karr = torch.arange(probe, device=tb.device)

    def read(self, i, t):
        """The tb byte of state (i, t)."""
        return self.tb_flat[
            torch.clamp(i - 1, 0, self.n - 1) * (self.B * self.W)
            + self.base + torch.clamp(t, 0, self.W - 1)].long()

    def classify(self, i, t, mat):
        j = i + t + self.lo
        active = (i > 0) | (j > 0)
        lead_y = active & (i == 0)                 # leading insertions
        col0_x = active & (i > 0) & (j == 0)       # leading deletions
        inner = (i > 0) & (j > 0)
        return (j, active, lead_y, col0_x, inner & (mat == 0),
                inner & (mat == 1), inner & (mat == 2))

    def probe(self, i, t, di, dt):
        """(B, probe) bytes of states (i - k di, t + k dt)."""
        k = self.karr[None, :]
        rows = torch.clamp(i[:, None] - 1 - k * di[:, None], 0, self.n - 1)
        slots = torch.clamp(t[:, None] + k * dt[:, None], 0, self.W - 1)
        return self.tb_flat[rows * (self.B * self.W) + self.base[:, None]
                            + slots].long()

    def run_length(self, v, i, j, is_m, is_x, is_y, m_by_byte=False):
        """Cells of the run that starts at the probed state, 1..probe
        (0 for a row that is none of M, X, Y).  `m_by_byte`: an M run's
        first cell counts only if its own byte's source is M, as the
        events walk of the JAX package probes it (the carried kind and
        the byte agree wherever a forward pass wrote the byte)."""
        prev = v[:, :-1]
        cont = torch.where(
            is_m[:, None], (v[:, 1:] & 3) == 0,
            torch.where(is_x[:, None], ((prev >> 2) & 1) == 1,
                        ((prev >> 3) & 1) == 1))
        lim = torch.where(is_m, torch.minimum(i, j),
                          torch.where(is_x, i, j))
        first = (is_m | is_x | is_y)[:, None]
        head = first
        if m_by_byte:
            head = first & (~is_m[:, None] | ((v[:, :1] & 3) == 0))
        okk = (torch.cat([head, cont], dim=1) & first
               & (self.karr[None, :] < lim[:, None]))
        return torch.cumprod(okk.long(), dim=1).sum(dim=1)

    def edge_of_run(self, i, t, active, dt, r):
        """True where a run of r states from (i, t) along dt visits a
        border slot (t <= 0 or t >= W - 1) at a row i > 0."""
        span = dt * torch.clamp(r - 1, min=0)
        return (active & (i > 0)
                & ((t + torch.clamp(span, max=0) <= 0)
                   | (t + torch.clamp(span, min=0) >= self.W - 1)))

    @staticmethod
    def next_mat(is_m, is_x, is_y, last, nxt, mat):
        """The move kind after a run: `last` is the byte of the run's
        last state, `nxt` the byte of the state it lands on.  A Y *open*
        came from G = min(M, X), whose argmin is bit 4."""
        return torch.where(
            is_m, nxt & 3,
            torch.where(
                is_x, torch.where(((last >> 2) & 1) == 1, 1, nxt & 3),
                torch.where(
                    is_y, torch.where(((last >> 3) & 1) == 1, 2,
                                      (nxt >> 4) & 1), mat)))


def gotoh_traceback(tb: torch.Tensor, ref: torch.Tensor, q: torch.Tensor,
                    t_end: torch.Tensor, lo: int, n: int):
    """Walk the packed traceback, emitting the ref-projected alignment.

    Returns (aligned (B, n) uint8 ('-' for deletions), done (B,) bool,
    band_edge (B,) bool — True if the path touched the band border,
    walk_cost (B,) int32 — the walked path's cost, for validation
    against the forward score).

    Each iteration retires one run of every row: up to DENSE_PROBE - 1 cells
    of an M, X or Y run found by a line probe, or the whole of a leading
    insertion (i == 0) or leading deletion (j == 0).  The cells, flags
    and costs are those the cell-by-cell walk of the JAX package
    visits.  Deleted sites keep the '-' the rows are filled with.
    """
    B, m_pad = q.shape
    W = tb.shape[2]
    dev = tb.device
    GAP = ord("-")
    refl = ref.long()
    ql = q.long()
    wk = _Walker(tb, lo, n, DENSE_PROBE)
    bidx, karr = wk.bidx, wk.karr
    R = DENSE_PROBE
    # column 0 (j = 0) is one closed-form X run: cell (i', 0) sits in
    # slot -lo - i' (clamped as every read is) and costs an extension,
    # an open where its bit 2 is clear and, as the cell-by-cell walk
    # charges it, a Y step as well where it was entered as Y (source 2
    # under a cell that did not extend X; no forward emits that)
    rows = torch.arange(n, device=dev)
    c0 = tb[rows, :, torch.clamp(-lo - 1 - rows, 0, W - 1)].long()  # (n, B)
    as_y = GAP_EXT + GAP_OPEN * (1 - ((c0 >> 3) & 1))
    col0_y = torch.zeros_like(c0)
    col0_y[:-1] = torch.where(
        (((c0[1:] >> 2) & 1) == 0) & ((c0[:-1] & 3) == 2), as_y[:-1], 0)
    col0_cost = torch.cumsum(
        GAP_EXT + GAP_OPEN * (1 - ((c0 >> 2) & 1)) + col0_y, dim=0)

    def body(carry):
        i, t, mat, cur, out, edge, cost = carry
        j, active, lead_y, col0_x, is_m, is_x, is_y = wk.classify(i, t, mat)
        di = (is_m | is_x).long()
        dt = is_x.long() - is_y.long()
        v = wk.probe(i, t, di, dt)
        runlen = torch.clamp(wk.run_length(v, i, j, is_m, is_x, is_y),
                             max=R - 1)
        kmask = karr[None, :] < runlen[:, None]

        rowidx = i[:, None] - 1 - karr[None, :]
        qch = ql[bidx[:, None],
                 torch.clamp(j[:, None] - 1 - karr[None, :], 0, m_pad - 1)]
        refch = refl[torch.clamp(rowidx, 0, n - 1)]
        m_cells = kmask & is_m[:, None]
        out[bidx[:, None], torch.where(m_cells, rowidx, n)] = \
            qch.to(torch.uint8)                         # n: the spill column
        ext = torch.where(is_x[:, None], (v >> 2) & 1, (v >> 3) & 1)
        run_cost = torch.where(
            is_m, MISMATCH * (m_cells & (qch != refch)).sum(dim=1),
            GAP_EXT * runlen
            + GAP_OPEN * (kmask & (ext == 0)).sum(dim=1))
        top = torch.clamp(i - 1, 0, n - 1)
        run_cost = torch.where(
            col0_x, col0_cost[top, bidx] - col0_y[top, bidx]
            + torch.where(mat == 2, as_y[top, bidx], 0), run_cost)

        r = torch.where(lead_y, j, torch.where(col0_x, i, runlen))
        di = di + col0_x.long()
        dt = dt + col0_x.long() - lead_y.long()
        ni = i - r * di
        nt = t + r * dt
        nj = ni + nt + lo
        run_cost = run_cost + torch.where(
            (i > 0) & (ni == 0) & (nj > 0), GAP_OPEN + GAP_EXT * nj, 0)
        edge = edge | wk.edge_of_run(i, t, active, dt, r)
        moved = is_m | is_x | is_y
        last = torch.gather(v, 1, torch.clamp(runlen - 1, min=0)[:, None])
        nxt = torch.gather(v, 1, runlen[:, None])[:, 0]
        nmat = wk.next_mat(is_m, is_x, is_y, last[:, 0], nxt, mat)
        return (ni, nt, nmat, torch.where(moved, nxt, cur), out, edge,
                cost + run_cost)

    i = torch.full((B,), n, dtype=torch.long, device=dev)
    t = t_end.to(torch.long, copy=True)   # the walks update it in place
    cur = wk.read(i, t)
    carry = (i, t, cur & 3, cur,
             torch.full((B, n + 1), GAP, dtype=torch.uint8, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev),
             torch.zeros(B, dtype=torch.long, device=dev))
    # every iteration retires >= 1 path step per active row, so the
    # cap only guards against a corrupt traceback (done=False rows)
    i_f, t_f, _, _, out, edge, cost = _walk(body, carry, lo, n + m_pad + 2)
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
    iteration) and a PROBE-byte line probe for partial blocks; a gap run
    retires PROBE cells an iteration, a leading insertion or deletion
    all of its cells at once.  A run retired whole records its one
    checkpoint where it starts, as the cell-by-cell walk does.

    Returns (ev_i (B,K) int32, ev_t (B,K) int32, cnt (B,) int32,
    done (B,) bool, edge (B,) bool, overflow (B,) bool).  Rows with
    overflow=True exceeded K checkpoints and must be re-walked densely.
    """
    _, B, W = tb.shape
    dev = tb.device
    BL1, BL2, allm1, allm2 = _all_m_blocks(tb, n)
    n1, n2 = allm1.shape[0], allm2.shape[0]
    wk = _Walker(tb, lo, n, PROBE)
    bidx = wk.bidx

    def body(carry):
        i, t, mat, kprev, cnt, ev_i, ev_t, edge, ovf = carry
        j, active, lead_y, col0_x, is_m, is_x, is_y = wk.classify(i, t, mat)
        kind = torch.where(is_m, 0, torch.where(is_x | col0_x, 1, 2))

        rec = active & (kprev >= 0) & (kind != kprev)
        pos = torch.where(rec & (cnt < K), cnt, K)
        ev_i[bidx, pos] = i
        ev_t[bidx, pos] = t
        ovf = ovf | (rec & (cnt >= K))
        cnt = cnt + rec.long()
        kprev = torch.where(active, kind, kprev)

        di = (is_m | is_x).long()
        dt = is_x.long() - is_y.long()
        v = wk.probe(i, t, di, dt)
        runlen = wk.run_length(v, i, j, is_m, is_x, is_y, m_by_byte=True)

        # ---- M: the longest provable diagonal run, by blocks or probe
        tcl = torch.clamp(t, 0, W - 1)
        r_top = i - 1                          # topmost tb row consumed
        blk1 = torch.clamp(torch.div(r_top, BL1, rounding_mode="floor"),
                           0, n1 - 1)
        blk2 = torch.clamp(torch.div(r_top, BL2, rounding_mode="floor"),
                           0, n2 - 1)
        cand1 = torch.where(allm1[blk1, bidx, tcl], blk1 * BL1, i)
        cand2 = torch.where(allm2[blk2, bidx, tcl], blk2 * BL2, i)
        i2 = torch.minimum(torch.minimum(cand1, cand2), i - runlen)
        i2 = torch.maximum(i2, torch.clamp(-t - lo, min=0))  # keep j2 >= 0

        r = torch.where(lead_y, j, torch.where(col0_x, i, runlen))
        di = di + col0_x.long()
        dt = dt + col0_x.long() - lead_y.long()
        edge = edge | wk.edge_of_run(i, t, active, dt, r)
        ni = torch.where(is_m, i2, i - r * di)
        nt = t + r * dt
        last = torch.gather(v, 1, torch.clamp(runlen - 1, min=0)[:, None])
        nmat = wk.next_mat(is_m, is_x, is_y, last[:, 0], wk.read(ni, nt),
                           mat)
        return ni, nt, nmat, kprev, cnt, ev_i, ev_t, edge, ovf

    i = torch.full((B,), n, dtype=torch.long, device=dev)
    t = t_end.to(torch.long, copy=True)   # the walks update it in place
    zeros = lambda *shape, dt=torch.long: torch.zeros(shape, dtype=dt,
                                                      device=dev)
    # column K of ev_i / ev_t is the spill column of the dropping scatter
    carry = (i, t, wk.read(i, t) & 3,
             torch.full((B,), -1, dtype=torch.long, device=dev), zeros(B),
             zeros(B, K + 1), zeros(B, K + 1), zeros(B, dt=torch.bool),
             zeros(B, dt=torch.bool))
    # the cap only guards against a corrupt traceback (done=False rows)
    i, t, _, _, cnt, ev_i, ev_t, edge, ovf = _walk(
        body, carry, lo, 2 * n + 2 * W + 8)
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
