"""The port's banded Gotoh modules against the JAX package's.

On the CPU the wrappers of ops/gotoh_kernels.py run their plain PyTorch
versions, held exactly (tolerance 0: every output is an integer or a
byte) against uvaia_tpu.ops.gotoh and against the Pallas kernels run in
interpret mode, as tests/test_gotoh.py runs them.  The traceback walks,
the output packing and the group aligners of ops/gotoh.py are held
against their JAX counterparts, and align_batch against the O(nm)
oracle.  tests/test_torch_gpu.py holds the CUDA kernels against these
plain versions on the card.
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
