"""The port's banded Gotoh modules against the JAX package's.

On the CPU the wrappers of ops/gotoh_kernels.py run their plain PyTorch
versions, held exactly (tolerance 0: every output is an integer or a
byte) against uvaia_tpu.ops.gotoh and against the Pallas kernels run in
interpret mode, as tests/test_gotoh.py runs them.  The traceback walks,
the output packing and the group aligners of ops/gotoh.py are held
against their JAX counterparts, and align_batch against the O(nm)
oracle.  tests/test_torch_gpu.py holds the CUDA kernels against these
plain versions on the card.  The register kernel's schedule (slot
ownership, the shifted query window, the lane prefix minimum, pad slots,
the one-barrier exchange between warps) is restated in numpy here and
held against the plain version and the JAX forward, since the kernel
itself runs only on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvaia_tpu.ops import gotoh as jg
from uvaia_tpu.ops import pallas_gotoh
from uvaia_tpu_torch.ops import gotoh as pg
from uvaia_tpu_torch.ops import gotoh_kernels as gk

from test_gotoh import oracle_score, rand_dna
from torch_cases import GAP_CASES, gap_case

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _inputs(seed: int, n: int, B: int):
    """ref (n,), q (B, m_pad), qlen (B,): SNPs and short indels, rows
    shorter and longer than the reference, zero padding past every
    row, and a last row that repeats row 0 (as batches are padded)."""
    rng = np.random.default_rng(seed)
    ref = ACGT[rng.integers(0, 4, n)]
    qs = []
    for b in range(B):
        q = bytearray(ref.tobytes())
        for _ in range(int(rng.integers(0, 8))):
            q[int(rng.integers(0, len(q)))] = ACGT[rng.integers(0, 4)]
        p = int(rng.integers(0, len(q) - 20))
        ln = int(rng.integers(0, 10))
        if b % 2:
            del q[p:p + ln]
        else:
            q[p:p] = bytes(ACGT[rng.integers(0, 4, ln)])
        if b % 4 == 1:
            q = q[:len(q) - int(rng.integers(5, 25))]    # short tail
        elif b % 4 == 3:
            q += bytes(ACGT[rng.integers(0, 4, int(rng.integers(5, 20)))])
        qs.append(bytes(q))
    if B > 1:
        qs[-1] = qs[0]
    m_pad = max(len(q) for q in qs) + 37
    arr = np.zeros((B, m_pad), np.uint8)
    lens = np.zeros(B, np.int32)
    for b, q in enumerate(qs):
        arr[b, :len(q)] = np.frombuffer(q, np.uint8)
        lens[b] = len(q)
    return ref, arr, lens


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _equal(port, jax_out):
    for p, j in zip(port, jax_out, strict=True):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


BANDS = [(-32, 65), (-16, 97), (-8, 17), (-64, 129)]


@pytest.mark.parametrize("B", [1, 8, 13])
@pytest.mark.parametrize("lo,width", BANDS)
@pytest.mark.parametrize("n", [80, 300])
def test_forward_matches_jax(n, lo, width, B):
    ref, arr, lens = _inputs(n + B, n, B)
    got = gk.gotoh_forward(*_t(ref, arr, lens), lo, width)
    _equal(got, jg.gotoh_forward(*_j(ref, arr, lens), lo, width))
    assert got[0].dtype == torch.uint8 and got[0].shape == (n, B, width)
    assert all(x.dtype == torch.int32 for x in got[1:])
    if B == 8:
        _equal(gk.gotoh_score(*_t(ref, arr, lens), lo, width),
               jg.gotoh_score(*_j(ref, arr, lens), lo, width))


@pytest.mark.parametrize("lo,width", [(-32, 65), (-16, 97)])
def test_score_matches_pallas_interpret(lo, width):
    ref, arr, lens = _inputs(31, 300, 8)
    _equal(gk.gotoh_score(*_t(ref, arr, lens), lo, width),
           pallas_gotoh.gotoh_score_pallas(*_j(ref, arr, lens), lo, width,
                                           interpret=True))


def test_forward_matches_pallas_interpret():
    """score, t_end and edge everywhere, and the same walks from both
    traceback buffers.  The Pallas kernel does not clamp y to INF, so
    its tb may differ in the bits that compare y (0, 1 and 3) at cells
    whose cost reaches INF, which no path crosses; bits 2 and 4 agree
    at every valid cell (0 <= j <= qlen)."""
    n, lo, W = 200, -32, 65
    ref, arr, lens = _inputs(7, n, 8)
    tb, *rest = gk.gotoh_forward(*_t(ref, arr, lens), lo, W)
    tb_p, *rest_p = pallas_gotoh.gotoh_forward_pallas(
        *_j(ref, arr, lens), lo, W, interpret=True)
    _equal(rest, rest_p)
    t_end = rest[1]
    tb_p = torch.from_numpy(np.array(tb_p))
    _equal(pg.gotoh_traceback_events(tb, t_end, lo, n, jg.EV_CAP),
           [x.numpy() for x in pg.gotoh_traceback_events(
               tb_p, t_end, lo, n, jg.EV_CAP)])
    _equal(pg.gotoh_traceback(tb, *_t(ref, arr), t_end, lo, n),
           [x.numpy() for x in pg.gotoh_traceback(
               tb_p, *_t(ref, arr), t_end, lo, n)])
    j = np.arange(1, n + 1)[:, None, None] + lo + np.arange(W)[None, None]
    valid = (j >= 0) & (j <= lens[None, :, None])
    np.testing.assert_array_equal(tb.numpy()[valid] & 0x14,
                                  tb_p.numpy()[valid] & 0x14)


@pytest.mark.parametrize("K", [jg.EV_CAP, 3])
@pytest.mark.parametrize("n,lo,width,B", [(300, -64, 129, 13),
                                          (80, -8, 17, 8)])
def test_traceback_events_matches_jax(n, lo, width, B, K):
    ref, arr, lens = _inputs(50 + n, n, B)
    tb, _, t_end, _ = gk.gotoh_forward(*_t(ref, arr, lens), lo, width)
    got = pg.gotoh_traceback_events(tb, t_end, lo, n, K)
    want = jg.gotoh_traceback_events(jnp.asarray(tb.numpy()),
                                     jnp.asarray(t_end.numpy()), lo, n, K)
    _equal(got, want)
    if K == 3:
        assert got[-1].any()            # some rows overflow at K = 3


@pytest.mark.parametrize("n,lo,width,B", [(300, -64, 129, 13),
                                          (80, -8, 17, 8)])
def test_dense_traceback_matches_jax(n, lo, width, B):
    ref, arr, lens = _inputs(70 + n, n, B)
    tb, _, t_end, _ = gk.gotoh_forward(*_t(ref, arr, lens), lo, width)
    got = pg.gotoh_traceback(tb, *_t(ref, arr), t_end, lo, n)
    want = jg.gotoh_traceback(jnp.asarray(tb.numpy()), *_j(ref, arr),
                              jnp.asarray(t_end.numpy()), lo, n)
    _equal(got, want)
    assert got[1].all()


@pytest.mark.parametrize("name", GAP_CASES)
def test_walks_retire_gap_runs_as_jax_walks_cells(name):
    """Both walks on paths with gap runs longer than the probe, runs at
    row 0, column 0 and the band's borders: events, counts, flags, cost
    and bytes equal the JAX package's cell-by-cell walks, in far fewer
    iterations than the run has cells."""
    ref, arr, lens, lo, W = gap_case(name)
    n = len(ref)
    tb, _, t_end, _ = gk.gotoh_forward(*_t(ref, arr, lens), lo, W)
    tb_j, t_end_j = jnp.asarray(tb.numpy()), jnp.asarray(t_end.numpy())
    before = dict(pg.walk_counts)
    _equal(pg.gotoh_traceback_events(tb, t_end, lo, n, jg.EV_CAP),
           jg.gotoh_traceback_events(tb_j, t_end_j, lo, n, jg.EV_CAP))
    ev_iters = pg.walk_counts["iterations"] - before["iterations"]
    got = pg.gotoh_traceback(tb, *_t(ref, arr), t_end, lo, n)
    _equal(got, jg.gotoh_traceback(tb_j, *_j(ref, arr), t_end_j, lo, n))
    if name != "outside_band":
        assert got[1].all()
        assert ev_iters <= 3 * pg.HOST_READ_EVERY, ev_iters
    assert got[2].item() == name.startswith(("band_edge", "outside"))


@pytest.mark.parametrize("seed", range(6))
def test_walks_match_jax_on_arbitrary_traceback_bytes(seed):
    """Random tb bytes (every source, both extension bits, source 3,
    which no forward emits and no walk leaves): paths leave the band,
    reads clamp, rows get stuck until the iteration cap.  The walks
    equal the JAX package's at every output all the same."""
    rng = np.random.default_rng(seed)
    n, B, lo, W = 24, 16, -6, 11
    tb = rng.integers(0, 32, (n, B, W)).astype(np.uint8)
    if seed % 2:
        tb &= ~np.uint8(3 * (rng.random((n, B, W)) < 0.8))   # mostly M
    tb[(tb & 3) == 3] &= np.uint8(0xFC | (seed % 3 == 0) * 3)
    ref = ACGT[rng.integers(0, 4, n)]
    arr = ACGT[rng.integers(0, 4, (B, n + 9))]
    t_end = rng.integers(0, W, B).astype(np.int32)
    for K in (4, 64):
        _equal(pg.gotoh_traceback_events(*_t(tb, t_end), lo, n, K),
               jg.gotoh_traceback_events(*_j(tb, t_end), lo, n, K))
    _equal(pg.gotoh_traceback(*_t(tb, ref, arr, t_end), lo, n),
           jg.gotoh_traceback(*_j(tb, ref, arr, t_end), lo, n))


@pytest.mark.parametrize("every", [1, 5, 64])
def test_host_read_interval_changes_nothing(every, monkeypatch):
    """An iteration on finished rows is idle: reading the loop condition
    every iteration, every 5 or every 64 gives the same outputs, and the
    host is asked about once in `every` iterations."""
    n, lo, W = 300, -64, 129
    ref, arr, lens = _inputs(350, n, 13)
    tb, _, t_end, _ = gk.gotoh_forward(*_t(ref, arr, lens), lo, W)
    want_ev = pg.gotoh_traceback_events(tb, t_end, lo, n, 3)
    want = pg.gotoh_traceback(tb, *_t(ref, arr), t_end, lo, n)
    monkeypatch.setattr(pg, "HOST_READ_EVERY", every)
    before = dict(pg.walk_counts)
    _equal(pg.gotoh_traceback_events(tb, t_end, lo, n, 3),
           [x.numpy() for x in want_ev])
    _equal(pg.gotoh_traceback(tb, *_t(ref, arr), t_end, lo, n),
           [x.numpy() for x in want])
    iters = pg.walk_counts["iterations"] - before["iterations"]
    reads = pg.walk_counts["host_reads"] - before["host_reads"]
    assert iters % every == 0 and reads == iters // every + 2


@pytest.mark.parametrize("E", [8, 1024])
def test_group_aligners_match_jax(E):
    """align_rows (events) and align_rows_dense (dense walk + packed
    diffs): the meta buffers and the dense rows, on a gathered subset
    with repeated indices."""
    n, lo, W, K = 300, -32, 65, 16
    ref, arr, lens = _inputs(90, n, 12)
    idx = np.array([3, 0, 7, 7, 11, 2, 5, 9], np.int32)
    _equal([pg.align_rows(*_t(ref, arr, lens, idx), lo, W, K)],
           [jg.align_rows(*_j(ref, arr, lens, idx), lo, W, K)])
    _equal(pg.align_rows_dense(*_t(ref, arr, lens, idx), lo, W, E),
           jg.align_rows_dense(*_j(ref, arr, lens, idx), lo, W, E))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_align_batch_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 80
    ref = rand_dna(rng, n)
    qs = []
    for _ in range(8):
        q = bytearray(ref)
        for _ in range(rng.integers(0, 6)):
            q[rng.integers(0, len(q))] = b"ACGT"[int(rng.integers(0, 4))]
        if rng.random() < 0.7:
            p = int(rng.integers(0, len(q) - 6))
            ln = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                del q[p:p + ln]
            else:
                q[p:p] = rand_dna(rng, ln)
        qs.append(bytes(q))
    arr = np.zeros((8, max(map(len, qs))), np.uint8)
    lens = np.array([len(q) for q in qs], np.int32)
    for b, q in enumerate(qs):
        arr[b, :len(q)] = np.frombuffer(q, np.uint8)
    ref_a = np.frombuffer(ref, np.uint8)
    got = pg.align_batch(ref_a, arr, lens, -32, 65)
    want = jg.align_batch(ref_a, arr, lens, -32, 65)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))
    aligned, score, ok = got[:3]
    assert ok.all()
    for b, q in enumerate(qs):
        assert score[b] == oracle_score(ref, q), f"query {b}"


def test_host_half_is_the_jax_package_s():
    """The jax-free copies compute what uvaia_tpu's host functions do."""
    assert (pg.INF, pg.MISMATCH, pg.GAP_OPEN, pg.GAP_EXT, pg.OE,
            pg.EV_CAP) == (int(jg.INF), jg.MISMATCH, jg.GAP_OPEN,
                           jg.GAP_EXT, jg.OE, jg.EV_CAP)
    rng = np.random.default_rng(4)
    meta = rng.integers(0, 1 << 20, (5, 6 + 2 * 7)).astype(np.int32)
    for a, b in zip(pg.unpack_meta_events(meta, 7),
                    jg.unpack_meta_events(meta, 7), strict=True):
        np.testing.assert_array_equal(a, b)
    meta = rng.integers(0, 1 << 30, (5, 5 + 8 + 2)).astype(np.int32)
    for a, b in zip(pg.unpack_meta(meta, 8), jg.unpack_meta(meta, 8),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    args = (rng.integers(0, 300, 9), rng.integers(0, 300, 9),
            rng.random(9) < 0.8, rng.integers(0, 300, 9),
            rng.integers(250, 350, 9), 300, -64, 129)
    for a, b in zip(pg.certify(*args), jg.certify(*args), strict=True):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# the register kernel's schedule (csrc/gotoh.cu:gotoh_reg_kernel), in numpy

_BIG = 2**31 - 1
_INF = pg.INF


def _lane_up(v, d, fill):
    """v of lane - d along the lane axis (axis 2), `fill` below lane d."""
    out = np.full_like(v, fill)
    out[:, :, d:] = v[:, :, :-d]
    return out


def _lanes_below_min(f):
    """The kernel's radix-4 exclusive prefix minimum over the lanes."""
    e = np.minimum.reduce([_lane_up(f, d, _BIG) for d in (1, 2, 3, 4)])
    e = np.minimum.reduce([e] + [_lane_up(e, d, _BIG) for d in (4, 8, 12)])
    return np.minimum(e, _lane_up(e, 16, _BIG))


def _schedule_forward(ref, q, qlen, lo, W, S, nw):
    """tb (n, B, W), score, t_end, edge as the register kernel computes
    them: thread (warp, lane) owns slots [(32 warp + lane) S, ... + S),
    arrays are (B, warp, lane, slot)."""
    n, (B, m_pad) = len(ref), q.shape
    t = np.arange(nw * 32 * S, dtype=np.int64).reshape(1, nw, 32, S)
    t_last = (np.arange(nw, dtype=np.int64) + 1) * 32 * S - 1
    ql = qlen.astype(np.int64).reshape(B, 1, 1, 1)
    rows = np.arange(B).reshape(B, 1, 1, 1)

    def qbyte(k):
        k = np.broadcast_to(k, (B,) + k.shape[1:])
        inb = (k >= 0) & (k < m_pad)
        return np.where(inb, q[np.broadcast_to(rows, k.shape),
                                np.clip(k, 0, m_pad - 1)], 0).astype(np.int64)

    j0 = t + lo
    H = np.where(j0 == 0, 0, np.where(j0 > 0, 6 + 2 * j0, _INF))
    H = np.where((j0 > ql) | (t >= W), _INF, H)
    X = np.full_like(H, _INF)
    qc = qbyte(j0)
    flat = lambda a: a.reshape(B, -1)
    edge = np.minimum(flat(H)[:, 0], flat(H)[:, W - 1])
    tb = np.zeros((n, B, W), np.uint8)
    for i in range(1, n + 1):
        fresh = qbyte((i + lo + t_last).reshape(1, nw, 1, 1))[:, :, 0, 0]
        hn = np.full((B, nw, 32), _INF, np.int64)
        xn = hn.copy()
        hn[:, :, :31], xn[:, :, :31] = H[:, :, 1:, 0], X[:, :, 1:, 0]
        # the first lane of each warp above publishes its slot's x
        xo, xe = H[:, 1:, 0, 0] + 8, X[:, 1:, 0, 0] + 2
        sh_x, sh_ext = np.minimum(xo, xe), xe <= xo          # (B, nw - 1)
        j = i + lo + t
        sub = np.where((j >= 1) & (j <= ql),
                       np.where(qc == ref[i - 1], 0, 4), _INF)
        m = H + sub
        xo = np.concatenate([H[..., 1:], hn[..., None]], -1) + 8
        xe = np.concatenate([X[..., 1:], xn[..., None]], -1) + 2
        x, x_ext = np.minimum(xo, xe), xe <= xo
        g = np.minimum(m, x)
        v = g - 2 * t
        below = np.concatenate(
            [np.full((B, nw, 32, 1), _BIG, np.int64),
             np.minimum.accumulate(v, -1)[..., :-1]], -1)
        fold = v.min(-1)
        run = _lanes_below_min(fold)
        g_before = _lane_up(g[..., S - 1], 1, 0)
        if nw > 1:
            sh_fold = np.minimum(run[:, :, 31], fold[:, :, 31])
            sh_g = g[:, :, 31, S - 1]
            c = np.minimum(sh_fold[:, :-1], sh_x - 2 * t_last[:-1])
            for w in range(1, nw):
                run[:, w] = np.minimum(run[:, w], c[:, :w].min(1)[:, None])
                g_before[:, w, 0] = np.minimum(sh_g[:, w - 1], sh_x[:, w - 1])
            x[:, :-1, 31, S - 1] = sh_x
            x_ext[:, :-1, 31, S - 1] = sh_ext
            g[:, :-1, 31, S - 1] = np.minimum(g[:, :-1, 31, S - 1], sh_x)
        y = np.where(t == 0, _INF, np.minimum(
            8 + 2 * (t - 1) + np.minimum(run[..., None], below), _INF))
        live = (j >= 0) & (j <= ql) & (t < W)
        h = np.where(live, np.minimum(g, y), _INF)
        xm = np.where(live, np.minimum(x, _INF), _INF)
        gp = np.concatenate([g_before[..., None], g[..., :-1]], -1)
        y_open = np.where(t == 0, _INF, gp + 8)
        gfx = xm < m
        src = np.where(y < g, 2, gfx)
        byte = src | (x_ext << 2) | ((y < y_open) << 3) | (gfx << 4)
        tb[i - 1] = flat(byte)[:, :W]
        edge = np.minimum(edge, np.minimum(flat(h)[:, 0], flat(h)[:, W - 1]))
        H, X = h, xm
        q_in = np.empty((B, nw, 32), np.int64)
        q_in[:, :, :31], q_in[:, :, 31] = qc[:, :, 1:, 0], fresh
        qc = np.concatenate([qc[..., 1:], q_in[..., None]], -1)
    assert (flat(H)[:, W:] == _INF).all() and (flat(X)[:, W:] == _INF).all()
    t_end = qlen.astype(np.int64) - n - lo
    score = np.where((t_end >= 0) & (t_end < W),
                     flat(H)[np.arange(B), np.clip(t_end, 0, W - 1)], _INF)
    return tb, score, t_end, edge


def _off_band_inputs(seed, n, B):
    """_inputs plus one row far shorter than the reference, one far
    longer (both run off the band's query ends), and an empty row."""
    ref, arr, lens = _inputs(seed, n, B)
    lens[1] = n // 3
    arr[1, lens[1]:] = 0
    lens[2] = 0
    arr[2] = 0
    extra = np.frombuffer(bytes(ACGT[np.random.default_rng(seed).integers(
        0, 4, n)]), np.uint8)
    arr = np.concatenate([arr, np.zeros((B, n), np.uint8)], 1)
    arr[3, lens[3]:lens[3] + n] = extra
    lens[3] += n
    return ref, arr, lens


# width -> the plans held: forward_plan's own and, forced, plans of
# several warps (pad slots inside the last warp, an exact fit, one slot a
# thread) that only wider bands take on the card
SCHEDULES = [(1, None), (2, None), (31, None), (33, None), (129, None),
             (160, None), (161, None), (129, (2, 3)), (161, (1, 6)),
             (64, (1, 2)), (70, (3, 2)), (33, (1, 8))]


@pytest.mark.parametrize("W,plan", SCHEDULES)
def test_register_schedule_matches_plain_and_jax(W, plan):
    """The schedule equals the plain version and the JAX forward at every
    tb cell, score, t_end and edge, with rows shorter and longer than
    the reference whose band runs off both query ends."""
    n, B = 90, 6
    lo = -(W // 2)
    ref, arr, lens = _off_band_inputs(W, n, B)
    S, nw = plan or gk.forward_plan(W)
    assert 32 * nw * S >= W
    got = _schedule_forward(ref, arr, lens, lo, W, S, nw)
    want = gk.gotoh_forward_plain(*_t(ref, arr, lens), lo, W)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w.numpy())
    for g, w in zip(got, jg.gotoh_forward(*_j(ref, arr, lens), lo, W),
                    strict=True):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_lanes_below_min_is_the_exclusive_prefix_min():
    rng = np.random.default_rng(3)
    f = rng.integers(-1000, 1000, (4, 2, 32)).astype(np.int64)
    want = np.concatenate([np.full((4, 2, 1), _BIG),
                           np.minimum.accumulate(f, 2)[:, :, :-1]], 2)
    np.testing.assert_array_equal(_lanes_below_min(f), want)


@pytest.mark.parametrize("W,want", [
    (1, (1, 1)), (32, (1, 1)), (33, (2, 1)), (129, (5, 1)), (160, (5, 1)),
    (161, (6, 1)), (257, (9, 1)), (513, (17, 1)), (544, (17, 1)),
    (545, (3, 6)), (1025, (5, 7)), (4097, (17, 8)), (4352, (17, 8)),
    (4353, (0, 0)), (15361, (0, 0))])
def test_forward_plan(W, want):
    """The variant comes from the width alone: one warp a row up to
    WARP_MAX_WIDTH, a CTA up to REG_MAX_WIDTH, then the wide kernel; a
    register plan always covers the band with a compiled slot count."""
    assert gk.forward_plan(W) == want
    S, nw = want
    if S:
        assert S in gk.REG_SLOTS and 1 <= nw <= gk.REG_MAX_WARPS
        assert 32 * nw * S >= W > 32 * (nw - 1) * S
        assert (nw == 1) == (W <= gk.WARP_MAX_WIDTH)
    else:
        assert W > gk.REG_MAX_WIDTH
