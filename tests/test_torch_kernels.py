"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version, held
exactly (tolerance 0: every value is an integer count or code) against
the Pallas kernel it replaces, run in interpret mode as the JAX tests
run it.  tests/test_torch_gpu.py holds the CUDA kernels themselves
against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvaia_tpu.core.encoding import encode
from uvaia_tpu.ops import pallas_recon, pallas_score
from uvaia_tpu.ops import scan as jscan
from uvaia_tpu_torch.ops import host, recon, score_kernels as sk

import torch_cases
from test_scan import make_pack, random_alignment


def _t(x):
    return torch.from_numpy(np.array(x))


def _counter_inputs(seed, Q, L=700, B=37, acgt=False):
    rng = np.random.default_rng(seed)
    pack = make_pack(rng, n_query=Q, L=L, acgt=acgt)
    jqd = jscan.build_device_data(pack, k=5)
    refs = np.stack([encode(s) for s in random_alignment(rng, B, L, 0.1)])
    return jqd, refs


@pytest.mark.parametrize("Q", [6, 100])
def test_counters_match_pallas_full(Q):
    jqd, refs = _counter_inputs(40 + Q, Q)
    W = int(jqd.q_full.shape[1])
    rc = np.pad(refs, ((0, 0), (0, W - refs.shape[1])))
    mats, cons5 = pallas_score.mats_and_cons_via_pallas(
        jnp.asarray(rc), jqd.q_full, jqd.cons_full, interpret=True)
    aa, mm, vv, c5 = sk.score_counters(_t(rc), _t(jqd.q_full),
                                       _t(jqd.cons_full))
    np.testing.assert_array_equal(torch.stack([aa, mm, vv], -1).numpy(),
                                  np.asarray(mats))
    np.testing.assert_array_equal(c5.numpy(), np.asarray(cons5))
    assert aa.dtype == c5.dtype == torch.int32


@pytest.mark.parametrize("Q", [6, 100])
def test_counters_match_pallas_packed(Q):
    jqd, refs = _counter_inputs(50 + Q, Q, L=701)   # odd L: a pad nibble
    packed = host.pack_codes(refs)
    mats, cons5 = pallas_score.mats_and_cons_via_pallas_packed(
        jnp.asarray(packed), jqd.q_full, jqd.cons_full, interpret=True)
    aa, mm, vv, c5 = sk.score_counters_packed(_t(packed), _t(jqd.q_full),
                                              _t(jqd.cons_full))
    np.testing.assert_array_equal(torch.stack([aa, mm, vv], -1).numpy(),
                                  np.asarray(mats))
    np.testing.assert_array_equal(c5.numpy(), np.asarray(cons5))


def _acgt_equal(got, mats, cons5):
    np.testing.assert_array_equal(torch.stack(got[:4], -1).numpy(),
                                  np.asarray(mats))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(cons5))
    assert all(t.dtype == torch.int32 for t in got)


@pytest.mark.parametrize("Q", [6, 100])
def test_acgt_counters_match_pallas(Q):
    """The --acgt counters against _kernel_acgt_main + _kernel_acgt_poly
    in interpret mode."""
    jqd, refs = _counter_inputs(60 + Q, Q, acgt=True)
    assert np.asarray(jqd.q_poly).any()
    W = int(jqd.q_full.shape[1])
    rc = np.pad(refs, ((0, 0), (0, W - refs.shape[1])))
    mats, cons5 = pallas_score.mats_and_cons_acgt_via_pallas(
        jnp.asarray(rc), jqd.q_full, jqd.q_poly, jqd.cons_full,
        interpret=True)
    _acgt_equal(sk.acgt_counters(_t(rc), _t(jqd.q_full), _t(jqd.q_poly),
                                 _t(jqd.cons_full)), mats, cons5)


@pytest.mark.parametrize("Q", [6, 100])
def test_acgt_counters_match_pallas_packed(Q):
    """The packed --acgt counters against the packed Pallas pair."""
    jqd, refs = _counter_inputs(70 + Q, Q, L=701, acgt=True)  # a pad nibble
    packed = host.pack_codes(refs)
    mats, cons5 = pallas_score.mats_and_cons_acgt_via_pallas_packed(
        jnp.asarray(packed), jqd.q_full, jqd.q_poly, jqd.cons_full,
        interpret=True)
    _acgt_equal(sk.acgt_counters_packed(_t(packed), _t(jqd.q_full),
                                        _t(jqd.q_poly), _t(jqd.cons_full)),
                mats, cons5)


@pytest.mark.parametrize("B,Q,S", [(64, 16, 512), (37, 9, 500)])
def test_pair_counters_match_pallas(B, Q, S):
    """pair_counters (any S) against pair_counter_mats in interpret
    mode, whose inputs are zero-padded to its tiles as
    tests/test_pallas.py pads them."""
    rng = np.random.default_rng(B + S)
    refs = np.stack([encode(s) for s in random_alignment(rng, B, S, 0.1)])
    qs = np.stack([encode(s) for s in random_alignment(rng, Q, S, 0.1)])
    bt, qt, st = 32, 8, 128
    r = np.pad(refs, ((0, -B % bt), (0, -S % st)))
    q = np.pad(qs, ((0, -Q % qt), (0, -S % st)))
    want = np.asarray(pallas_score.pair_counter_mats(
        jnp.asarray(r), jnp.asarray(q), bt=bt, qt=qt, st=st,
        interpret=True))[:B, :Q]
    got = sk.pair_counters(_t(refs), _t(qs))
    np.testing.assert_array_equal(torch.stack(got, -1).numpy(), want)
    assert want[..., 1].any()


@pytest.mark.parametrize("B,Q,A", [(37, 9, 40), (130, 70, 24)])
def test_corr_matches_pallas(B, Q, A):
    """Codes dense in ambiguity, every code 0-15 (15 included)."""
    rng = np.random.default_rng(B + Q + A)
    r = rng.integers(0, 16, (B, A)).astype(np.uint8)
    q = rng.integers(0, 16, (Q, A)).astype(np.uint8)
    r[:, :2] = 15
    q[:, 1:3] = 15
    r[0, :] = 0
    t, p = pallas_score.corr_via_pallas(jnp.asarray(r), jnp.asarray(q),
                                        interpret=True)
    t2, p2 = sk.amb_corr(_t(r), _t(q))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(t))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(p))
    assert np.asarray(t).any() and np.asarray(p).any()


def _all_code_pairs(A=12):
    """r (16, A), q (16, A): row a holds code a in every column, so the
    (16, 16) outputs hold every pair of the 16 codes, A times."""
    codes = np.repeat(np.arange(16, dtype=np.uint8)[:, None], A, axis=1)
    return codes, codes.copy()


def _random_pack(B, Q, A, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, (B, A)).astype(np.uint8),
            rng.integers(0, 16, (Q, A)).astype(np.uint8))


@pytest.mark.parametrize("case", ["pairs", (37, 9, 44), (130, 70, 20),
                                  (5, 3, 4), (64, 64, 100)])
def test_corr_plane_products_match_plain_and_pallas(case):
    """The 22 plane products the CUDA kernel runs (16 query planes:
    one-hot ambiguity codes, mask bits on ambiguous codes, the ambiguous
    plane) equal the per-site definition and the Pallas kernel in
    interpret mode — on every pair of the 16 codes, and on random packs
    whose column count is no multiple of 32."""
    r, q = _all_code_pairs() if case == "pairs" else _random_pack(*case, 5)
    assert case == "pairs" or r.shape[1] % 32
    got = sk.amb_corr_products(_t(r), _t(q))
    for g, w in zip(got, sk.amb_corr_plain(_t(r), _t(q)), strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    want = pallas_score.corr_via_pallas(jnp.asarray(r), jnp.asarray(q),
                                        interpret=True)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "pairs":
        t, p = (x.numpy() // r.shape[1] for x in got)
        amb = np.array([bin(c).count("1") >= 2 for c in range(16)])
        np.testing.assert_array_equal(t, np.diag(amb).astype(np.int32))
        assert p[3, 12] == 0 and p[3, 5] == 0 and p[15, 15] == -3
        assert p[7, 11] == -1 and not p[~amb].any() and not p[:, ~amb].any()


def test_corr_code_tables():
    """The ambiguity codes are the codes of two or more bases, and the
    complement of a two-base code is a two-base code."""
    assert sk.AMB_CODES == tuple(c for c in range(16)
                                 if bin(c).count("1") >= 2)
    assert sk.PAIR_CODES == tuple(c for c in range(16)
                                  if bin(c).count("1") == 2)
    assert {15 - c for c in sk.PAIR_CODES} == set(sk.PAIR_CODES)


def test_corr_of_an_empty_column_set():
    z = torch.zeros((3, 0), dtype=torch.uint8)
    t, p = sk.amb_corr(z, torch.zeros((2, 0), dtype=torch.uint8))
    assert t.shape == p.shape == (3, 2) and not t.any() and not p.any()


def _delta_batch(seed, B=24, L=900):
    """Rows with SNPs, zero runs (so zero-run markers occur), a masked
    tail, and one ok=False row, delta-encoded against a base."""
    rng = np.random.default_rng(seed)
    base = np.stack([encode(s) for s in random_alignment(rng, 1, L)])[0]
    codes = np.tile(base, (B, 1))
    snp = rng.random((B, L)) < 0.02
    codes[snp] = rng.integers(0, 16, int(snp.sum()))
    for r in range(B):
        s = int(rng.integers(0, L - 80))
        codes[r, s:s + int(rng.integers(5, 80))] = 0
    codes[1, L - 60:] = 0
    ok = np.ones(B, dtype=bool)
    ok[3] = False
    pos, val = host.delta_encode(codes, ok, base)
    assert (val >= 16).any() and (val >= 32).any()
    return codes, ok, base, pos, val


@pytest.mark.parametrize("width", [None, 1024])
def test_rebuild_matches_pallas(width):
    codes, ok, base, pos, val = _delta_batch(7)
    L = base.shape[0]
    w = L if width is None else width
    # the TPU path of uvaia_tpu.ops.scan.reconstruct_delta, in
    # interpret mode: the Pallas paint, then the run unmask
    if w % 128 == 0:
        img = pallas_recon.reconstruct_image(
            jnp.asarray(pos), jnp.asarray(val),
            jnp.pad(jnp.asarray(base), (0, w - L)), w, interpret=True)
    else:
        img = pallas_recon.reconstruct_image(
            jnp.asarray(pos), jnp.asarray(val), jnp.asarray(base), L,
            out_width=w, interpret=True)
    want = np.asarray(jscan._unmask_runs(img))
    got = recon.delta_rebuild(_t(pos), _t(val), _t(base), width)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the rebuild inverts the encoder (ok=False rows come back as
    # the base)
    exp = np.where(ok[:, None], codes, base[None, :])
    np.testing.assert_array_equal(got.numpy()[:, :L], exp)


def test_rebuild_int32_positions():
    """The Python encoder's wide positions (int32 on the device) give
    the same rows as uint16 ones."""
    _, _, base, pos, val = _delta_batch(8)
    a = recon.delta_rebuild(_t(pos), _t(val), _t(base), 1024)
    b = recon.delta_rebuild(_t(pos.astype(np.int32)), _t(val), _t(base),
                            1024)
    assert torch.equal(a, b)


def _rebuild_both(pos, val, base, width):
    """The port's rebuild on the CPU (the plain version) and the JAX
    package's reconstruct_delta on the same entries."""
    got = recon.delta_rebuild(_t(pos), _t(val), _t(base), width)
    assert torch.equal(got, recon.delta_rebuild_plain(
        _t(pos), _t(val), _t(base), base.shape[0] if width is None
        else width))
    want = jscan.reconstruct_delta(jnp.asarray(base), jnp.asarray(pos),
                                   jnp.asarray(val), width)
    return got.numpy(), np.asarray(want)


def test_rebuild_named_odd_rows():
    """A code inside a run, two starts before one end, a run without an
    end, an end before any start, adjacent runs, a marker-free row, an
    empty row: the expected rows, from the port and the JAX package."""
    names, pos, val, base, want = torch_cases.named_delta_rows()
    for width in (None, 256):
        got, jax_rows = _rebuild_both(pos, val, base, width)
        L = base.shape[0]
        for name, b in names.items():
            np.testing.assert_array_equal(got[b, :L], want[b], err_msg=name)
        np.testing.assert_array_equal(got, jax_rows)
        assert not got[:, L:].any()


@pytest.mark.parametrize("E,L,width,pos_dtype", [
    (128, 900, None, np.uint16),         # a ragged width (900 = 16 * 56 + 4)
    (128, 901, None, np.int32),
    (256, 2000, 2048, np.uint16),
    (4096, 5003, 5120, np.uint16),       # the largest delta bucket
    (4096, 5003, None, np.int32),
    (16, 70000, 70016, np.int32),        # positions past uint16
])
def test_rebuild_random_markers_match_jax(E, L, width, pos_dtype):
    """Random codes and markers at random unique positions (nested
    starts, early ends, open runs, codes inside runs, padding slots,
    empty and marker-free rows), ordered as the encoder orders them."""
    pos, val, base = torch_cases.random_delta_batch(
        E + L, 16, E, L, pos_dtype=pos_dtype)
    got, want = _rebuild_both(pos, val, base, width)
    np.testing.assert_array_equal(got, want)


def test_rebuild_takes_any_order_of_positions():
    """Shuffled slots (padding between real entries, markers out of
    order) give the rows of the same entries in ascending order."""
    a = torch_cases.random_delta_batch(5, 12, 64, 700)
    b = torch_cases.random_delta_batch(5, 12, 64, 700, ascending=False)
    np.testing.assert_array_equal(a[2], b[2])
    assert (np.sort(a[0], 1) == np.sort(b[0], 1)).all() and (a[0] != b[0]).any()
    rows = [recon.delta_rebuild(*(_t(x) for x in args), 704)
            for args in (a, b)]
    assert torch.equal(*rows)


def test_rebuild_of_the_store_s_and_the_encoder_s_entries(tmp_path):
    """What the two producers emit is what the rebuild's fast path
    expects: real entries first, ascending, then ascending padding at
    pos >= L — from ops/host.delta_encode (native and Python encoder)
    and from a sequence store's delta blocks; and the rows come back."""
    from uvaia_tpu.io import store as jstore
    from uvaia_tpu_torch.io import store as pstore

    codes, ok, base, pos, val = _delta_batch(21)
    rng = np.random.default_rng(3)
    fa = tmp_path / "db.fa"
    with open(fa, "w") as f:
        for r, s in enumerate(random_alignment(rng, 40, 900)):
            s = bytearray(s)
            if r % 3 == 0:
                a = int(rng.integers(0, 800))
                n_run = min(int(rng.integers(10, 90)), len(s) - a)
                s[a:a + n_run] = b"N" * n_run
            f.write(f">s{r}\n{bytes(s).decode()}\n")
    jstore.ingest([str(fa)], str(tmp_path / "db.store"), block=16)
    st = pstore.Store(str(tmp_path / "db.store"))
    batches = [(pos, val, base.shape[0])]
    for bi in range(len(st.blocks)):
        d = st.block_delta(bi)
        if d is not None:
            batches.append((np.asarray(d[0]), np.asarray(d[1]), st.n_sites))
    assert len(batches) > 1
    for p, v, L in batches:
        p = p.astype(np.int64)
        real = p < L
        assert (real[:, :-1] >= real[:, 1:]).all()       # real entries first
        assert (np.diff(p, axis=1) > 0).all()            # all ascending
    row0 = 0
    for bi in range(len(st.blocks)):
        d = st.block_delta(bi)
        n = int(st.blocks[bi][1])
        if d is not None:
            got = recon.delta_rebuild(_t(np.asarray(d[0])),
                                      _t(np.asarray(d[1])), _t(st.base))
            np.testing.assert_array_equal(
                got.numpy(), st.codes_rows(np.arange(row0, row0 + n)))
        row0 += n


def test_rebuild_empty_batch_and_width_limits():
    base = torch.arange(50, dtype=torch.uint8) % 16
    out = recon.delta_rebuild(torch.zeros((0, 8), dtype=torch.int32),
                              torch.zeros((0, 8), dtype=torch.uint8), base, 64)
    assert out.shape == (0, 64) and out.dtype == torch.uint8
    # the kernel's shared-memory budget: the row plus 8 bytes an entry
    assert recon.MAX_WIDTH % 16 == 0
    assert (recon.MAX_WIDTH + 80 + 8 * recon.MAX_ENTRIES
            <= recon.SHARED_BYTES)
    assert recon.MAX_ENTRIES == host.DELTA_BUCKETS[-1]


def test_wrappers_refuse_bad_inputs():
    q = torch.zeros((3, 1024), dtype=torch.uint8)
    c = torch.zeros(1024, dtype=torch.uint8)
    with pytest.raises(ValueError, match="sites"):
        sk.score_counters(torch.zeros((4, 1000), dtype=torch.uint8), q, c)
    with pytest.raises(ValueError, match="uint8"):
        sk.score_counters(torch.zeros((4, 1024), dtype=torch.int32), q, c)
    with pytest.raises(ValueError, match="columns"):
        sk.amb_corr(torch.zeros((4, 8), dtype=torch.uint8),
                    torch.zeros((3, 16), dtype=torch.uint8))
    with pytest.raises(ValueError, match="width"):
        recon.delta_rebuild(torch.zeros((2, 4), dtype=torch.int32),
                            torch.zeros((2, 4), dtype=torch.uint8),
                            torch.zeros(10, dtype=torch.uint8), 5)


def test_new_wrappers_refuse_bad_inputs():
    """The --acgt and pair wrappers check their inputs as the full-mode
    ones do, and refuse a device that is neither cuda nor cpu."""
    r = torch.zeros((4, 1024), dtype=torch.uint8)
    q = torch.zeros((3, 1024), dtype=torch.uint8)
    c = torch.zeros(1024, dtype=torch.uint8)
    with pytest.raises(ValueError, match="q_poly"):
        sk.acgt_counters(r, q, torch.zeros((2, 1024), dtype=torch.uint8), c)
    with pytest.raises(ValueError, match="sites"):
        sk.acgt_counters(r[:, :1000].contiguous(), q, q, c)
    with pytest.raises(ValueError, match="more"):
        sk.acgt_counters_packed(torch.zeros((4, 513), dtype=torch.uint8),
                                q, q, c)
    with pytest.raises(ValueError, match="uint8"):
        sk.pair_counters(r.to(torch.int32), q)
    with pytest.raises(ValueError, match="sites"):
        sk.pair_counters(r[:, :1000].contiguous(), q)
    meta = [t.to("meta") for t in (r, q, c)]
    with pytest.raises(ValueError, match="device meta"):
        sk.acgt_counters(meta[0], meta[1], meta[1], meta[2])
    with pytest.raises(ValueError, match="device meta"):
        sk.pair_counters(meta[0], meta[1])
