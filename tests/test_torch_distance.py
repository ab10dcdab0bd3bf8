"""The port's ops/distance.py against uvaia_tpu.ops.distance on the same
numpy inputs, at the scenarios of tests/test_distance.py.

Tolerances: every integer output (mismatch counts, ACGT / text matches,
valid pairs) is exact.  The weighted partial match is summed exactly in
the port (an integer multiple of 1/144, rounded once to float32) and in
float32 by the JAX package, so the two may differ by float32's rounding
of a sum of L terms: rtol 1e-6 (a few units in the last place); against
the per-pair oracle in float64, atol 1e-3 as tests/test_distance.py has
it, and exact where every weight is a binary fraction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvaia_tpu.core import oracle
from uvaia_tpu.core.encoding import ENCODE_LUT, encode
from uvaia_tpu.ops import distance as jdist
from uvaia_tpu_torch.ops import distance as pdist

from test_scan import random_alignment


def _codes(seed, n, L, mut):
    rng = np.random.default_rng(seed)
    return np.stack([encode(s) for s in random_alignment(rng, n, L, mut)])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("acgt", [False, True])
@pytest.mark.parametrize("P", [0, 1, 200])
def test_mismatch_weights_and_pair_mismatches(acgt, P):
    refs = _codes(3, 12, 200, 0.1)[:, :P]
    qs = _codes(4, 5, 200, 0.1)[:, :P]
    w = pdist.mismatch_weights(qs, acgt)
    np.testing.assert_array_equal(w, jdist.mismatch_weights(qs, acgt))
    got = pdist.pair_mismatches(_t(refs), _t(w))
    assert got.dtype == torch.int32 and got.shape == (12, 5)
    want = np.asarray(jdist.pair_mismatches(jnp.asarray(refs),
                                            jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), want)
    fn = oracle.pair_mismatch_acgt if acgt else oracle.pair_hamming_indelcheck
    for b in range(12):
        for q in range(5):
            assert got[b, q] == fn(qs[q], refs[b])


@pytest.mark.parametrize("acgt", [False, True])
def test_cons_mismatches(acgt):
    refs = _codes(4, 9, 300, 0.08)
    cons = _codes(5, 1, 300, 0.08)[0]
    rng = np.random.default_rng(6)
    for sites in (np.arange(300, dtype=np.int32),
                  np.sort(rng.choice(300, 77, replace=False)).astype(np.int32),
                  np.zeros(0, np.int32)):
        got = pdist.cons_mismatches(_t(refs), _t(sites), _t(cons[sites]),
                                    acgt)
        want = jdist.cons_mismatches(jnp.asarray(refs), jnp.asarray(sites),
                                     jnp.asarray(cons[sites]), acgt)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rule", ["product", "jaccard", "max"])
@pytest.mark.parametrize("trim", [0, 20])
def test_legacy_query_data_matches_jax(rule, trim):
    qs = _codes(7, 4, 300, 0.2)
    got = pdist.build_legacy_query_data(qs, trim, rule)
    want = jdist.build_legacy_query_data(qs, trim, rule)
    for key in ("a_q", "v_q", "amb_cols", "w_text", "window"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    # the port's planes are integers: 12 x and 144 x the float planes
    np.testing.assert_allclose(got["mn_q"].numpy() / 12.0,
                               np.asarray(want["mn_q"]), rtol=1e-7)
    if rule == "product":
        assert got["w_part"] is None and want["w_part"] is None
    else:
        np.testing.assert_allclose(got["w_part"].numpy() / 144.0,
                                   np.asarray(want["w_part"]), atol=1e-7)


@pytest.mark.parametrize("rule", ["product", "jaccard", "max"])
@pytest.mark.parametrize("trim", [0, 20])
def test_legacy_scores_match_jax_and_oracle(rule, trim):
    refs = _codes(8, 7, 300, 0.2)
    qs = _codes(9, 4, 300, 0.2)
    got = pdist.legacy_scores(
        pdist.build_legacy_query_data(qs, trim, rule), _t(refs))
    assert got.dtype == torch.float32 and got.shape == (7, 4, 4)
    got = got.numpy()
    want = np.asarray(jdist.legacy_scores(
        jdist.build_legacy_query_data(qs, trim, rule), jnp.asarray(refs)))
    for k in (0, 1, 3):
        np.testing.assert_array_equal(got[..., k], want[..., k])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-6)
    sl = slice(trim, 300 - trim)
    for b in range(7):
        for q in range(4):
            a, t, _, v = oracle.pair_counters(qs[q][sl], refs[b][sl])
            w = sum(oracle.partial_weight(int(c1), int(c2), rule)
                    for c1, c2 in zip(qs[q][sl], refs[b][sl]))
            assert (got[b, q, 0], got[b, q, 1], got[b, q, 3]) == (a, t, v)
            np.testing.assert_allclose(got[b, q, 2], w, atol=1e-3)
            assert got[b, q, 2] == np.float32(w) or abs(
                got[b, q, 2] - w) <= np.spacing(np.float32(w))
    with pytest.raises(ValueError):
        pdist.build_legacy_query_data(qs, 0, partial_rule="bogus")


def test_partial_weight_recoverable_entries():
    """The crafted pair of tests/test_distance.py: T-T, T-A, T-W, N-T,
    A-N, M-R give 1 + 0 + 0.5 + 0 + 0 + 0.25, exactly."""
    c = lambda ch: int(ENCODE_LUT[ord(ch)])
    qs = np.array([[c("T"), c("T"), c("T"), 0, c("A"), c("M")]], np.uint8)
    rf = np.array([[c("T"), c("A"), c("W"), c("T"), 0, c("R")]], np.uint8)
    got = pdist.legacy_scores(pdist.build_legacy_query_data(qs, 0),
                              _t(rf))[0, 0]
    assert got.tolist() == [1.0, 1.0, 1.75, 4.0]


def test_every_code_pair_weight_is_a_multiple_of_1_144():
    """The exact sum rests on this: under each rule 144 x the weight of
    every (query code, reference code) pair is an integer, and one site
    a pair gives exactly that weight."""
    codes = np.arange(16, dtype=np.uint8)
    qs = np.repeat(codes, 16)[None, :]
    rf = np.tile(codes, 16)[None, :]
    for rule in ("product", "jaccard", "max"):
        w = np.array([oracle.partial_weight(int(a), int(b), rule)
                      for a, b in zip(qs[0], rf[0])])
        assert np.allclose(w * 144, np.round(w * 144), atol=1e-9)
        qd = pdist.build_legacy_query_data(qs, 0, rule)
        got = pdist.legacy_scores(qd, _t(rf))[0, 0, 2].item()
        assert got == np.float32(np.round(w * 144).sum() / 144)


def test_exact_dot_chunks_long_contractions(monkeypatch):
    """Sums past float32's exact integers: the contraction is cut into
    chunks that stay below 2**24 and added up in int64."""
    monkeypatch.setattr(pdist, "_EXACT", 1 << 10)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 13, (5, 4000))
    b = rng.integers(0, 13, (3, 4000))
    got = pdist.exact_dot([_t(a)], [_t(b)], max_term=144)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), a @ b.T)
    assert int(got.max()) > 1 << 10


def test_legacy_scores_past_uint16_sites():
    """L >= 2**16 (the int32 score store's case): counters equal L."""
    L = 70_000
    rng = np.random.default_rng(2)
    q = np.array([1, 2, 4, 8], np.uint8)[rng.integers(0, 4, (1, L))]
    r = np.concatenate([q, q], 0)
    r[1, :50] = 0
    got = pdist.legacy_scores(pdist.build_legacy_query_data(q, 0), _t(r))
    assert got[0, 0].tolist() == [L, L, L, L]
    assert got[1, 0].tolist() == [L - 50] * 4
