"""Plain reference of `align`: QC, and whether an emitted row is the
reference-coordinate projection of a least-cost global alignment.

Written from uvaia's definitions (align.c:60-64: match 0, mismatch 4
for unequal bytes, a gap of g bases 6 + 2g; utils.c:11-48 and
align.c:194-202 for QC) in numpy and plain torch, as a frozen yardstick
beside ``chip_smoke.py``'s O(nm) oracle (``oracle_score``, commit
0e5ecf2, copied below for the tests).  It imports nothing of the
program and works from the generated reference and query letters.

A row is judged by two costs of one banded dynamic programme over the
same band:
* the least cost of any global alignment of the query (the optimum);
* the least cost of an alignment whose projection is the emitted row
  (at a reference site with a letter the query base there equals it,
  at a '-' the site is deleted, query bases between sites are
  insertions).
The row is optimal when the two are equal.  The band holds every path
that costs no more than a known alignment (the greedy embedding of the
row in the query): such a path visiting diagonal d pays at least
2 (|d| + |d - (m - n)|) in gap extensions, which bounds d.
"""

from __future__ import annotations

import numpy as np
import torch

MISMATCH, GAP_OPEN, GAP_EXT = 4, 6, 2
OE = GAP_OPEN + GAP_EXT
INF = 1 << 29
GAP = ord("-")
_PURE = np.zeros(256, dtype=bool)
_PURE[np.frombuffer(b"ACGTUacgtu", np.uint8)] = True
_AMBIG = np.zeros(256, dtype=bool)
_AMBIG[np.frombuffer(b"MRWSYKVHDBmrwsykvhdb", np.uint8)] = True


def qc(q: bytes, n: int, ambiguity: float) -> bool:
    """align's QC: length within [2/3, 3/2] of the reference, N share at
    most `ambiguity`, ACGT share at least 1 - 1.1 x `ambiguity`."""
    m = len(q)
    if 3 * m < 2 * n or 2 * m > 3 * n:
        return False
    a = np.frombuffer(q, np.uint8)
    acgt = _PURE[a].sum() / m
    other = 1.0 - acgt - _AMBIG[a].sum() / m
    return other <= ambiguity and acgt >= 1.0 - 1.1 * ambiguity


def _runs_cost(mask: np.ndarray) -> int:
    """Gap cost of the runs of True in a 1-D bool array."""
    if not mask.any():
        return 0
    edges = np.diff(np.concatenate([[0], mask.view(np.int8), [0]]))
    starts, ends = np.nonzero(edges == 1)[0], np.nonzero(edges == -1)[0]
    return int(len(starts) * GAP_OPEN + GAP_EXT * (ends - starts).sum())


def greedy_cost(ref: bytes, q: bytes, row: bytes) -> int | None:
    """Cost of the alignment that projects to `row` with the query's
    bases placed leftmost, or None when `row` is no projection of `q`
    (wrong length, or its letters are not a subsequence of q)."""
    n = len(ref)
    if len(row) != n:
        return None
    r = np.frombuffer(row, np.uint8)
    qa = np.frombuffer(q, np.uint8)
    has = r != GAP
    s = r[has]
    k = len(qa) - len(s)
    if k < 0:
        return None
    skipped = []
    i, off = 0, 0
    while i < len(s):
        seg = qa[i + off:i + off + len(s) - i]
        bad = np.nonzero(seg != s[i:i + len(seg)])[0]
        if len(seg) < len(s) - i and not len(bad):
            return None
        if not len(bad):
            break
        i += int(bad[0])
        skipped.append(i + off)
        off += 1
        if off > k:
            return None
    ins = np.zeros(len(qa), dtype=bool)
    ins[skipped] = True
    ins[len(s) + off:] = True                     # the tail after s
    ref_a = np.frombuffer(ref, np.uint8)
    mism = int((has & (r != ref_a)).sum())
    return MISMATCH * mism + _runs_cost(~has) + _runs_cost(ins)


def _band(n: int, m: int, upper: int):
    """(lo, width) of the diagonals d = j - i that a path of cost at
    most `upper` can visit."""
    delta = m - n
    e = max(0, (upper - 2 * abs(delta)) // (2 * GAP_EXT))
    lo = max(min(0, delta) - e, -n)
    hi = min(max(0, delta) + e, m)
    return lo, hi - lo + 1


def _pad_queries(qs, device):
    """(B, max_m + 2) letters, query base j (1-based) at column j."""
    mx = max(len(q) for q in qs)
    arr = np.zeros((len(qs), mx + 2), dtype=np.uint8)
    for b, q in enumerate(qs):
        arr[b, 1:len(q) + 1] = np.frombuffer(q, np.uint8)
    return torch.from_numpy(arr).to(device)


GRAPH_STEPS = 64      # DP rows a CUDA graph replays (launch-bound loop)


def _dp(ref_d, qp, m, lo, W, rows=None, held=None, saturate=None,
        traceback=False):
    """Banded Gotoh over slots t = d - lo (per row), rows i = 1..n.
    `rows` ((B, n) letters) constrains the paths of the rows that `held`
    ((B,) bool) marks to project onto them;
    `saturate` caps reachable costs (the control); `traceback` keeps
    the step bits.  Returns (final costs (B,), tb or None).  On a CUDA
    device the rows run as replays of a graph of GRAPH_STEPS rows."""
    dev = ref_d.device
    n = ref_d.shape[0]
    B, Wm = lo.shape[0], int(W.max())
    t = torch.arange(Wm, device=dev, dtype=torch.int32)[None, :]
    ok_slot = t < W[:, None]
    lo2, m2 = lo[:, None], m[:, None]
    j = (lo2 + t).contiguous()
    h = torch.where(j == 0, 0, GAP_OPEN + GAP_EXT * j).to(torch.int32)
    h = torch.where(ok_slot & (j >= 0) & (j <= m2), h, INF)
    x = torch.full_like(h, INF)
    inf_col = torch.full((B, 1), INF, dtype=torch.int32, device=dev)
    tb = (torch.empty((n, B, Wm), dtype=torch.uint8, device=dev)
          if traceback else None)
    cap = INF if saturate is None else saturate
    free = None if held is None else ~held[:, None]
    i_d = torch.zeros(1, dtype=torch.int64, device=dev)
    qmax = qp.shape[1] - 1

    def step():
        i_d.add_(1)
        j.add_(1)
        jv = ok_slot & (j >= 0) & (j <= m2)
        qj = torch.gather(qp, 1, j.clamp(0, qmax).long())
        sub = torch.where(qj == ref_d.index_select(0, i_d - 1), 0, MISMATCH)
        m_ok = jv & (j >= 1)
        x_ok = jv
        if rows is not None:
            letter = rows.index_select(1, i_d - 1)
            gap = letter == GAP
            m_ok = m_ok & (free | (~gap & (qj == letter)))
            x_ok = x_ok & (free | gap)
        mrow = torch.where(m_ok, h + sub, INF)
        x_open = torch.cat([h[:, 1:], inf_col], 1) + OE
        x_ext = torch.cat([x[:, 1:], inf_col], 1) + GAP_EXT
        xrow = torch.where(x_ok, torch.minimum(x_open, x_ext), INF)
        g = torch.minimum(mrow, xrow)
        c = torch.cummin(g - GAP_EXT * t, dim=1).values
        y = torch.cat([inf_col, c[:, :-1] + GAP_OPEN + GAP_EXT * t[:, 1:]], 1)
        y = torch.where(jv, y, INF)
        hn = torch.minimum(g, y)
        if saturate is not None:
            hn = torch.where(hn < INF, hn.clamp(max=cap), INF)
            xrow = torch.where(xrow < INF, xrow.clamp(max=cap), INF)
            y = torch.where(y < INF, y.clamp(max=cap), INF)
            g = torch.where(g < INF, g.clamp(max=cap), INF)
        if traceback:
            src = torch.where(y < g, 2, (xrow < mrow).to(torch.int32))
            y_open = torch.cat([inf_col, g[:, :-1] + OE], 1)
            y_ext = torch.cat([inf_col, y[:, :-1] + GAP_EXT], 1)
            bits = (src | ((x_ext <= x_open).to(torch.int32) << 2)
                    | ((y_ext <= y_open).to(torch.int32) << 3)
                    | ((xrow < mrow).to(torch.int32) << 4)).to(torch.uint8)
            tb.index_copy_(0, i_d - 1, bits[None])
        h.copy_(hn.clamp(max=INF))
        x.copy_(xrow.clamp(max=INF))

    done = 0
    if dev.type == "cuda" and n >= 4 * GRAPH_STEPS:
        for _ in range(2):                  # warm-up rows, run eagerly
            step()
        done = 2
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_STEPS):
                step()
        while done + GRAPH_STEPS <= n:
            graph.replay()
            done += GRAPH_STEPS
        torch.cuda.synchronize()
        del graph
    for _ in range(n - done):
        step()
    t_end = (m - n - lo).long()
    inside = (t_end >= 0) & (t_end < W)
    fin = h.gather(1, t_end.clamp(0, Wm - 1)[:, None])[:, 0]
    return torch.where(inside, fin, INF), tb


def judge(ref: bytes, queries: list[bytes], rows: list[bytes], device,
          block: int = 256):
    """For each (query, emitted row): (optimum, cost of the row's best
    alignment), the second None when the row projects from no
    alignment.  Blocks of rows keep the band tensors small."""
    ref_d = torch.from_numpy(np.frombuffer(ref, np.uint8).copy()).to(device)
    n = len(ref)
    out = [None] * len(queries)
    todo = []
    for b, (q, row) in enumerate(zip(queries, rows)):
        up = greedy_cost(ref, q, row)
        if up is None:
            out[b] = (None, None)
        else:
            todo.append((b, up))
    for s in range(0, len(todo), block):
        part = todo[s:s + block]
        qs = [queries[b] for b, _ in part]
        bands = [_band(n, len(q), up) for q, (_, up) in zip(qs, part)]
        lo = torch.tensor([a for a, _ in bands], dtype=torch.int32,
                          device=device)
        W = torch.tensor([w for _, w in bands], dtype=torch.int32,
                         device=device)
        m = torch.tensor([len(q) for q in qs], dtype=torch.int32,
                         device=device)
        qp = _pad_queries(qs, device)
        rws = torch.from_numpy(np.stack(
            [np.frombuffer(rows[b], np.uint8) for b, _ in part])).to(device)
        both, _ = _dp(ref_d, torch.cat([qp, qp]), torch.cat([m, m]),
                      torch.cat([lo, lo]), torch.cat([W, W]),
                      rows=torch.cat([rws, rws]),
                      held=torch.arange(2 * len(part), device=device)
                      >= len(part))
        both = both.cpu().numpy()
        k = len(part)
        for r, (b, _) in enumerate(part):
            opt, own = int(both[r]), int(both[k + r])
            out[b] = (opt, None if own >= INF else own)
    return out


def control_rows(ref: bytes, queries: list[bytes], device,
                 saturate: int = 255) -> list[bytes]:
    """The control: rows of a DP whose reachable cells saturate at 255,
    as 8-bit lanes of striped aligners hold them, over the band that
    the program routes a row to (half-width the smallest of 64, 128,
    256, 512 covering |m - n| + 16), walked back through its steps."""
    ref_d = torch.from_numpy(np.frombuffer(ref, np.uint8).copy()).to(device)
    n = len(ref)
    halves = []
    for q in queries:
        d = abs(len(q) - n) + 16
        h = next((h for h in (64, 128, 256, 512) if d <= h), d)
        halves.append(h)
    lo = torch.tensor([-h for h in halves], dtype=torch.int32, device=device)
    W = torch.tensor([2 * h + 1 for h in halves], dtype=torch.int32,
                     device=device)
    m = torch.tensor([len(q) for q in queries], dtype=torch.int32,
                     device=device)
    qp = _pad_queries(queries, device)
    _, tb = _dp(ref_d, qp, m, lo, W, saturate=saturate, traceback=True)
    return _walk(tb.cpu().numpy(), ref, queries, lo.cpu().numpy())


def _walk(tb: np.ndarray, ref: bytes, queries, lo) -> list[bytes]:
    """Rows from the step bits, all queries at once (numpy)."""
    n, B, _ = tb.shape
    m = np.array([len(q) for q in queries])
    qa = np.zeros((B, m.max() + 1), dtype=np.uint8)
    for b, q in enumerate(queries):
        qa[b, 1:len(q) + 1] = np.frombuffer(q, np.uint8)
    rows = np.full((B, n), GAP, dtype=np.uint8)
    i = np.full(B, n)
    jj = m.copy()
    H, X, Y, G, M = 0, 1, 2, 3, 4
    state = np.full(B, H, dtype=np.int8)
    ar = np.arange(B)
    while True:
        b = ar[(i > 0) & (jj >= 0)]
        if not len(b):
            break
        ib, jb, st = i[b], jj[b], state[b]
        tslot = np.clip(jb - ib - lo[b], 0, tb.shape[2] - 1)
        bits = tb[ib - 1, b, tslot].astype(np.int64)
        src = bits & 3                           # H's source: 0 M, 1 X, 2 Y
        st = np.where(st == H, np.where(src == 0, M, src), st)
        st = np.where(st == G, np.where((bits >> 4) & 1, X, M), st)
        is_m, is_x, is_y = st == M, st == X, st == Y
        rows[b[is_m], ib[is_m] - 1] = qa[b[is_m], jb[is_m]]
        i[b] = np.where(is_y, ib, ib - 1)
        jj[b] = np.where(is_x, jb, jb - 1)
        state[b] = np.where(is_m, H,
                            np.where(is_x, np.where((bits >> 2) & 1, X, H),
                                     np.where((bits >> 3) & 1, Y, G)))
    return [rows[b].tobytes() for b in range(B)]


# ----------------------------------------------------------------------
# frozen copy of chip_smoke.py's oracle_score (commit 0e5ecf2): the
# optimal global affine-gap cost, dense O(nm), for the tests


def oracle_score(ref: bytes, q: bytes) -> int:
    X, O, E, BIG = MISMATCH, GAP_OPEN, GAP_EXT, 10**9
    n, m = len(ref), len(q)
    M = [[BIG] * (m + 1) for _ in range(n + 1)]
    Dx = [[BIG] * (m + 1) for _ in range(n + 1)]
    Iy = [[BIG] * (m + 1) for _ in range(n + 1)]
    M[0][0] = 0
    for j in range(1, m + 1):
        Iy[0][j] = O + E * j
    for i in range(1, n + 1):
        Dx[i][0] = O + E * i
    H = lambda i, j: min(M[i][j], Dx[i][j], Iy[i][j])
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = 0 if ref[i - 1] == q[j - 1] else X
            M[i][j] = H(i - 1, j - 1) + sub
            Dx[i][j] = min(H(i - 1, j) + O + E, Dx[i - 1][j] + E)
            Iy[i][j] = min(H(i, j - 1) + O + E, Iy[i][j - 1] + E)
    return H(n, m)
