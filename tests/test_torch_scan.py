"""The port's scan (uvaia_tpu_torch.ops.scan and ops.host) against the
JAX package's (uvaia_tpu.ops.scan) on the same inputs, on the CPU.
Every value is an integer, so every comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvaia_tpu.io.native as native
import uvaia_tpu_torch.io.native as port_native
from uvaia_tpu.core.encoding import encode
from uvaia_tpu.engine.query import QueryPack
from uvaia_tpu.ops import scan as jscan
from uvaia_tpu_torch.ops import host, scan

from test_scan import make_pack, random_alignment

AMBIG_CHARS = np.frombuffer(b"RYMKSWBDHV", dtype=np.uint8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pack(rng, n_query, L, trim=0, amb=True):
    if amb:
        return make_pack(rng, n_query=n_query, L=L, trim=trim)
    seqs = random_alignment(rng, n_query, L)
    seqs[np.isin(seqs, AMBIG_CHARS)] = ord("A")
    pack = QueryPack(names=[f"q{i}" for i in range(n_query)],
                     codes=np.stack([encode(s) for s in seqs]), acgt=False,
                     trim=trim)
    pack.create_indices()
    return pack


def _jax_fields(jqd) -> dict:
    d = {f: getattr(jqd, f) for f in
         ("acgt", "n_query", "n_sites", "k", "pack_keys")}
    for f in ("cons_full", "q_full", "amb_sites", "w_part", "w_text",
              "q_poly", "u_base", "q_pure_u", "idx_p", "pure_p_q",
              "amb_tot_q", "delta_base"):
        v = getattr(jqd, f)
        d[f] = None if v is None else np.asarray(v)
    return d


def _both(pack, k):
    jqd = jscan.build_device_data(pack, k=k)
    jscan.build_prune_data(jqd, pack)
    qd = scan.build_device_data(pack, k=k)
    scan.build_prune_data(qd, pack)
    return jqd, qd


@pytest.mark.parametrize("amb", [True, False])
def test_device_data_round_trip(amb):
    """build_device_data + build_prune_data equal the JAX package's
    arrays, and device_data_from_numpy carries them across unchanged."""
    pack = _pack(np.random.default_rng(3), 9, 650, trim=11, amb=amb)
    jqd, qd = _both(pack, 4)
    d = _jax_fields(jqd)
    carried = scan.device_data_from_numpy(d, "cpu")
    assert (qd.amb_sites is None) == (not amb)
    for name in scan._META:
        assert getattr(qd, name) == getattr(carried, name) == d[name]
    for name in scan._ARRAYS:
        want = d[name]
        for got in (getattr(qd, name), getattr(carried, name)):
            if want is None:
                assert got is None, name
                continue
            assert got.device.type == "cpu"
            assert got.numpy().dtype == want.dtype, name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("trim", [0, 13])
def test_device_data_round_trip_acgt(trim):
    """An --acgt pack: no ambiguity columns, a q_poly, and
    device_data_from_numpy carries the JAX package's q_poly across."""
    pack = make_pack(np.random.default_rng(4), n_query=5, L=300, acgt=True,
                     trim=trim)
    jqd, qd = _both(pack, 3)
    carried = scan.device_data_from_numpy(_jax_fields(jqd), "cpu")
    assert qd.acgt and carried.acgt and qd.amb_sites is None
    assert np.asarray(jqd.q_poly).any()
    for name in scan._ARRAYS:
        want = getattr(jqd, name)
        for got in (getattr(qd, name), getattr(carried, name)):
            if want is None:
                assert got is None, name
                continue
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)


@pytest.mark.parametrize("Q", [1, 7, 64, 129])
@pytest.mark.parametrize("trim", [0, 13])
@pytest.mark.parametrize("amb", [True, False])
def test_score_planes_match_jax(Q, trim, amb):
    rng = np.random.default_rng(100 + Q + trim)
    L = 600
    pack = _pack(rng, Q, L, trim=trim, amb=amb)
    jqd, qd = _both(pack, 5)
    refs = np.stack([encode(s) for s in random_alignment(rng, 21, L, 0.05)])
    want, want_valid = jscan.score_batch_planes(jqd, jnp.asarray(refs))
    got, got_valid = scan.score_batch_planes(qd, _t(refs))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    # the packed route gives the same planes
    got_p, _ = scan.score_batch_planes_packed(qd, _t(host.pack_codes(refs)))
    for g, w in zip(got_p, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("Q", [1, 7, 64, 129])
@pytest.mark.parametrize("trim", [0, 13])
def test_acgt_score_planes_match_jax(Q, trim):
    """--acgt planes (the s4/s5 split) and valid-site counts, unpacked and
    packed, against the JAX package's XLA path."""
    rng = np.random.default_rng(200 + Q + trim)
    L = 600
    pack = make_pack(rng, n_query=Q, L=L, acgt=True, trim=trim)
    jqd, qd = _both(pack, 5)
    refs = np.stack([encode(s) for s in random_alignment(rng, 21, L, 0.05)])
    want, want_valid = jscan.score_batch_planes(jqd, jnp.asarray(refs))
    for got, got_valid in (
            scan.score_batch_planes(qd, _t(refs)),
            scan.score_batch_planes_packed(qd, _t(host.pack_codes(refs)))):
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got_valid.numpy(),
                                      np.asarray(want_valid))
    assert np.asarray(want[5]).any() or Q == 1


def _stream(rng, L, n, dup_every=3):
    """n reference rows in which every dup_every-th row repeats an
    earlier one, so equal six-score keys (ties) occur."""
    refs = np.stack([encode(s) for s in random_alignment(rng, n, L, 0.03)])
    for i in range(dup_every, n, dup_every):
        refs[i] = refs[int(rng.integers(0, i))]
    return refs


@pytest.mark.parametrize("B,L", [(16, 500), (300, 500), (16, 33000)])
def test_merge_topk_matches_jax(B, L):
    """A stream of batches (duplicate rows, a padded last batch) through
    scan_step and scan_step_delta (scan_step_packed where the rows are
    too far from the delta base): same flags every step and the same final
    top-k as the JAX package.  B=300 exercises the 256-row candidate
    window and the full merge; L >= 2**15 the six unpacked sort keys."""
    rng = np.random.default_rng(21 + B)
    _stream_both(rng, _pack(rng, 5, L), B)


@pytest.mark.parametrize("trim", [0, 13])
@pytest.mark.parametrize("B", [16, 300])
def test_acgt_streamed_topk_matches_jax(B, trim):
    """test_merge_topk_matches_jax for an --acgt pack; at B=300 the odd
    batch travels packed."""
    rng = np.random.default_rng(31 + B + trim)
    _stream_both(rng, make_pack(rng, n_query=5, L=500, acgt=True,
                                trim=trim), B, packed=B == 300)


def _stream_both(rng, pack, B, packed=False):
    k, L = 6, pack.n_sites
    n = 3 * B - 5
    jqd, qd = _both(pack, k)
    assert qd.pack_keys == (L < 2**15)
    refs = _stream(rng, L, n)
    jstate = jscan.init_state(pack.n_query, k)
    state = scan.init_state(pack.n_query, k)
    base = np.asarray(jqd.delta_base)
    for step, start in enumerate(range(0, n, B)):
        batch = np.zeros((B, L), dtype=np.uint8)
        m = min(B, n - start)
        batch[:m] = refs[start:start + m]
        ok = np.zeros(B, dtype=bool)
        ok[:m] = True
        enc = host.delta_encode(batch, ok, base) \
            if step % 2 and not packed else None
        if enc is not None:
            pos, val = enc
            jstate, jflags = jscan.scan_step_delta(
                jqd, jstate, jnp.asarray(pos), jnp.asarray(val),
                jnp.asarray(ok), np.int32(start))
            state, flags = scan.scan_step_delta(qd, state, _t(pos), _t(val),
                                                _t(ok), start)
        elif step % 2:          # too many diffs for a delta: packed upload
            pk = host.pack_codes(batch)
            jstate, jflags = jscan.scan_step_packed(
                jqd, jstate, jnp.asarray(pk), jnp.asarray(ok),
                np.int32(start))
            state, flags = scan.scan_step_packed(qd, state, _t(pk), _t(ok),
                                                 start)
        else:
            jstate, jflags = jscan.scan_step(jqd, jstate, jnp.asarray(batch),
                                             jnp.asarray(ok),
                                             np.int32(start))
            state, flags = scan.scan_step(qd, state, _t(batch), _t(ok),
                                          start)
        np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
    idx = state[1].numpy()
    np.testing.assert_array_equal(idx, np.asarray(jstate[1]))
    # the scores of every filled slot (sentinel slots carry no score)
    real = idx != int(host.IDX_SENTINEL)
    assert real.all()
    np.testing.assert_array_equal(state[0].numpy()[real],
                                  np.asarray(jstate[0])[real])


def test_select_topk_ties_first_seen():
    """Equal keys rank by database index; sentinels sort last."""
    pack = _pack(np.random.default_rng(5), 2, 300)
    qd = scan.build_device_data(pack, k=3)
    s = torch.tensor([[[5, 1, 1, 1, 1, 1], [5, 1, 1, 1, 1, 1],
                       [9, 0, 0, 0, 0, 0], [7, 0, 0, 0, 0, 0]]] * 2,
                     dtype=torch.int32)
    idx = torch.tensor([[40, 12, int(host.IDX_SENTINEL), 30],
                        [3, 2, 1, 0]], dtype=torch.int32)
    out_s, out_i = scan.select_topk(qd, s, idx, 3)
    assert out_i.tolist() == [[30, 12, 40], [1, 0, 2]]
    assert out_s[0, :, 0].tolist() == [7, 5, 5]


def test_prune_step_matches_jax():
    rng = np.random.default_rng(31)
    _prune_both(rng, _pack(rng, 6, 500, trim=17))


@pytest.mark.parametrize("trim", [0, 13])
def test_acgt_prune_step_matches_jax(trim):
    """The --acgt bound (s1 <= min of the pure totals) prunes the same
    rows as the JAX package's."""
    rng = np.random.default_rng(33 + trim)
    _prune_both(rng, make_pack(rng, n_query=6, L=500, acgt=True, trim=trim))


def _prune_both(rng, pack):
    k, B = 4, 64
    L = pack.n_sites
    jqd, qd = _both(pack, k)
    # a first batch of the queries themselves sets high thresholds; the
    # second mixes near copies of them with unrelated rows
    refs = np.concatenate([np.resize(pack.codes, (B, L)),
                           np.resize(pack.codes, (B // 2, L)),
                           _stream(rng, L, B - B // 2)])
    near = refs[B:B + B // 4]          # a quarter mutated, a quarter exact
    near[rng.random(near.shape) < 0.01] = 1
    ok = np.ones(B, dtype=bool)
    ok[-3:] = False
    # thresholds from the first scored batch, then prune the second
    jstate, _ = jscan.scan_step(jqd, jscan.init_state(pack.n_query, k),
                                jnp.asarray(refs[:B]), jnp.asarray(ok),
                                np.int32(0))
    state, _ = scan.scan_step(qd, scan.init_state(pack.n_query, k),
                              _t(refs[:B]), _t(ok), 0)
    want = np.asarray(jscan.prune_step(jqd, jstate, jnp.asarray(refs[B:]),
                                       jnp.asarray(ok)))
    got = scan.prune_step(qd, state, _t(refs[B:]), _t(ok)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < ok.sum()       # the bound prunes something
    # the same mask from the packed and delta holds, and the held codes
    # are the rows at full width
    pk = host.pack_codes(refs[B:])
    got_p, codes_p = scan.prune_and_hold(qd, state, _t(pk), _t(ok))
    pos, val = host.delta_encode(refs[B:], ok, np.asarray(jqd.delta_base))
    got_d, codes_d = scan.prune_and_hold_delta(qd, state, _t(pos), _t(val),
                                               _t(ok))
    np.testing.assert_array_equal(got_p.numpy(), want)
    np.testing.assert_array_equal(got_d.numpy(), want)
    np.testing.assert_array_equal(codes_p.numpy()[:, :L], refs[B:])
    np.testing.assert_array_equal(codes_d.numpy()[ok, :L], refs[B:][ok])


def test_survivor_buffer_matches_jax():
    """accumulate_survivors + flush_survivors give the JAX state and
    flags; the port's buffer has one spill row past the capacity."""
    rng = np.random.default_rng(41)
    L, k, B, cap = 400, 3, 32, 64
    pack = _pack(rng, 4, L)
    jqd, qd = _both(pack, k)
    refs = _stream(rng, L, 2 * B)
    W = qd.width
    jbuf = (jnp.zeros((cap, W), jnp.uint8),
            jnp.full((cap,), jscan.IDX_SENTINEL, jnp.int32), jnp.int32(0))
    buf = scan.new_survivor_buffer(cap, W, "cpu")
    for b in range(2):
        rows = np.pad(refs[b * B:(b + 1) * B], ((0, 0), (0, W - L)))
        survive = rng.random(B) < 0.5
        jbuf = jscan.accumulate_survivors(*jbuf, jnp.asarray(rows),
                                          jnp.asarray(survive),
                                          np.int32(b * B))
        scan.accumulate_survivors(*buf, _t(rows), _t(survive), b * B)
        assert int(buf[2]) == int(jbuf[2])
    n = int(buf[2])
    np.testing.assert_array_equal(buf[0][:n].numpy(), np.asarray(jbuf[0])[:n])
    np.testing.assert_array_equal(buf[1][:n].numpy(), np.asarray(jbuf[1])[:n])
    jst, jflags = jscan.flush_survivors(
        jqd, jscan.init_state(pack.n_query, k), *jbuf)
    st, flags = scan.flush_survivors(qd, scan.init_state(pack.n_query, k),
                                     *buf)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
    np.testing.assert_array_equal(st[1].numpy(), np.asarray(jst[1]))
    np.testing.assert_array_equal(st[0].numpy(), np.asarray(jst[0]))


def _encoders_equal(rng):
    L, B = 700, 40
    codes = np.stack([encode(s) for s in random_alignment(rng, B, L, 0.05)])
    for r in range(0, B, 3):                  # zero runs -> run markers
        s = int(rng.integers(0, L - 90))
        codes[r, s:s + int(rng.integers(3, 90))] = 0
    codes[5, L - 40:] = 0
    ok = np.ones(B, dtype=bool)
    ok[7] = False
    base = host.majority_code(codes)
    np.testing.assert_array_equal(base, jscan.majority_code(codes))
    for odd in (codes, codes[:, :-1]):
        a, b = host.pack_codes(odd), jscan.pack_codes(odd)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got, want = host.delta_encode(codes, ok, base), \
        jscan.delta_encode(codes, ok, base)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    # a row past the largest bucket: both fall back to packed
    wide = np.tile(codes[:1], (2, 1))
    big = np.tile(wide, (1, 10))
    big[0] = rng.integers(1, 16, big.shape[1])
    assert host.delta_encode(big, np.ones(2, bool), big[1]) is None
    assert jscan.delta_encode(big, np.ones(2, bool), big[1]) is None


def test_host_encoders_match_jax_native():
    if native.get_lib() is None or port_native.get_lib() is None:
        pytest.skip("native IO unavailable")
    _encoders_equal(np.random.default_rng(51))


def test_host_encoders_match_jax_python(monkeypatch):
    monkeypatch.setenv("UVAIA_TPU_NO_NATIVE", "1")
    for mod in (native, port_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_failed", False)
    assert host._delta_lib() is None
    _encoders_equal(np.random.default_rng(51))
