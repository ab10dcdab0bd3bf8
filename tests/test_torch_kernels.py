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
