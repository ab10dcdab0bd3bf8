"""The port's sharded (db x site) scan (uvaia_tpu_torch.parallel.mesh)
against the JAX package's mesh (uvaia_tpu.parallel.mesh, on the 8
virtual CPU devices of tests/conftest.py) and against the port's
one-device steps, on the scenarios of tests/test_mesh.py.  The port's
shards are CPU shards.  Every value is an int32 count, index or flag,
so every comparison is exact."""

import filecmp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uvaia_tpu.engine.nearest as jnearest
from uvaia_tpu.core.encoding import encode
from uvaia_tpu.engine.query import QueryPack
from uvaia_tpu.ops import scan as jscan
from uvaia_tpu.parallel import mesh as jmesh
from uvaia_tpu_torch.engine import nearest as pnearest
from uvaia_tpu_torch.ops import host, scan
from uvaia_tpu_torch.parallel import mesh as pmesh

from test_nearest import random_seqs, write_fasta
from test_scan import random_alignment


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _t(x):
    return torch.from_numpy(np.array(x))


def _build(rng, acgt, L=520, n_query=5):
    qseqs = random_alignment(rng, n_query, L)
    codes = np.stack([encode(s) for s in qseqs])
    pack = QueryPack(names=[f"q{i}" for i in range(n_query)], codes=codes,
                     acgt=acgt, trim=0)
    pack.create_indices()
    return pack


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _state_equal(a, b):
    for x, y in zip(a, b, strict=True):
        _equal(x, y)


class _Three:
    """The JAX mesh, the port's CPU mesh and the port's one-device step
    over the same query pack and mesh shape."""

    def __init__(self, pack, k, shape, prune=False):
        n_db, n_site = shape
        self.pack, self.k, self.n_db = pack, k, n_db
        self.jm = jmesh.make_mesh(n_db, n_site)
        self.jqd = jscan.build_device_data(pack, k=k, site_shards=n_site)
        self.pm = pmesh.make_mesh(n_db, n_site, device_type="cpu")
        self.qd = scan.build_device_data(pack, k=k, site_shards=n_site)
        self.qd1 = scan.build_device_data(pack, k=k)
        if prune:
            for q in (self.jqd, self.qd, self.qd1):
                (jscan if q is self.jqd else scan).build_prune_data(q, pack)
        self.base = self.qd.delta_base.numpy()

    def init(self):
        return (jscan.init_state(self.pack.n_query, self.k),
                scan.init_state(self.pack.n_query, self.k),
                scan.init_state(self.pack.n_query, self.k))


def _batches(ref_codes, B, total):
    for start in range(0, total, B):
        batch = np.zeros((B, ref_codes.shape[1]), dtype=np.uint8)
        n = max(0, min(B, len(ref_codes) - start))
        ok = np.zeros(B, dtype=bool)
        batch[:n] = ref_codes[start:start + n]
        ok[:n] = True
        yield start, batch, ok, start + np.arange(B, dtype=np.int32)


def _run_steps(three, ref_codes, B, delta):
    """Sharded steps of both packages and the port's one-device step,
    batch by batch: flags equal at every step, states at the end."""
    t = three
    jstep = jmesh.make_sharded_scan_step(t.jqd, t.jm, delta=delta)
    pstep = pmesh.make_sharded_scan_step(t.qd, t.pm, delta=delta)
    js, ps, p1 = t.init()
    for start, batch, ok, ridx in _batches(ref_codes, B, 48):
        if delta:
            pos, val = host.delta_encode(batch, ok, t.base)
            js, jfl = jstep(js, jnp.asarray(pos), jnp.asarray(val),
                            jnp.asarray(ok), jnp.asarray(ridx))
            ps, pfl = pstep(ps, _t(pos), _t(val), _t(ok), _t(ridx))
        else:
            packed = host.pack_codes(batch)
            js, jfl = jstep(js, jnp.asarray(packed), jnp.asarray(ok),
                            jnp.asarray(ridx))
            ps, pfl = pstep(ps, _t(packed), _t(ok), _t(ridx))
        p1, fl1 = scan.scan_step(t.qd1, p1, _t(batch), _t(ok), start)
        _equal(pfl, jfl)
        _equal(pfl, fl1)
    _state_equal(ps, js)
    _state_equal(ps, p1)
    return ps


@pytest.mark.parametrize("acgt", [False, True])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_equals_single(acgt, shape):
    rng = np.random.default_rng(17)
    L, k, B = 520, 4, 16
    pack = _build(rng, acgt, L=L)
    ref_codes = np.stack([encode(r) for r in random_alignment(rng, 40, L)])
    _run_steps(_Three(pack, k, shape), ref_codes, B, delta=False)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_sharded_delta_equals_single(shape):
    """Sparse-delta sharded step == dense one-device step, bit for bit."""
    rng = np.random.default_rng(23)
    L, k, B = 520, 4, 16
    pack = _build(rng, False, L=L)
    ref_codes = np.stack([encode(r) for r in random_alignment(rng, 40, L)])
    _run_steps(_Three(pack, k, shape), ref_codes, B, delta=True)


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_site_sharded_corrections(shape, delta):
    """Full mode with ambiguous queries, and ambiguity columns beyond the
    first site block: the corrections take the query codes from the
    whole q_full, so the port's mesh equals the JAX mesh's CPU route
    (the w_part/w_text tables) and the port's one-device step."""
    rng = np.random.default_rng(41)
    L, k, B = 2500, 5, 16
    pack = _build(rng, False, L=L, n_query=6)
    three = _Three(pack, k, shape)
    w = three.qd.width // shape[1]
    assert three.qd.amb_sites is not None
    amb = three.qd.amb_sites.numpy()
    assert (amb[amb < L] >= w).any()       # columns outside block 0
    refs = random_alignment(rng, 40, L, mut=0.08)
    ref_codes = np.stack([encode(r) for r in refs])
    _run_steps(three, ref_codes, B, delta=delta)


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("acgt", [False, True])
def test_device_data_site_shards(S, acgt):
    """build_device_data(site_shards=S) pads to 1024 * S like the JAX
    package's, and every field equals it (device_data_from_numpy carries
    the JAX package's fields across the padded width too)."""
    rng = np.random.default_rng(5 + S)
    pack = _build(rng, acgt, L=2100, n_query=4)
    jqd = jscan.build_device_data(pack, k=3, site_shards=S)
    qd = scan.build_device_data(pack, k=3, site_shards=S)
    jscan.build_prune_data(jqd, pack)
    scan.build_prune_data(qd, pack)
    assert qd.width == int(jqd.q_full.shape[1]) == -(-2100 // (1024 * S)) \
        * 1024 * S
    d = {m: getattr(jqd, m) for m in scan._META}
    for name in scan._ARRAYS:
        v = getattr(jqd, name)
        d[name] = None if v is None else np.asarray(v)
    carried = scan.device_data_from_numpy(d, "cpu")
    for name in scan._ARRAYS:
        for got in (getattr(qd, name), getattr(carried, name)):
            if d[name] is None:
                assert got is None, name
                continue
            assert got.numpy().dtype == d[name].dtype, name
            _equal(got, d[name])


@pytest.mark.parametrize("acgt", [False, True])
def test_sharded_prune_mask_is_superset_and_exact(acgt):
    """Sharded phase-1 mask == the JAX package's == one-device mask."""
    rng = np.random.default_rng(23)
    L, k, B = 520, 4, 16
    pack = _build(rng, acgt, L=L)
    ref_codes = np.stack([encode(r) for r in random_alignment(rng, B, L)])
    t = _Three(pack, k, (4, 2), prune=True)
    # tighten the state first so the prefilter has real thresholds
    st = jscan.init_state(pack.n_query, k)
    st, _ = jscan.scan_step(jscan.build_device_data(pack, k=k), st,
                            jnp.asarray(ref_codes), jnp.ones(B, bool),
                            np.int32(0))
    pst = (_t(st[0]), _t(st[1]))
    packed = host.pack_codes(ref_codes)
    ok = np.ones(B, dtype=bool)
    want = jmesh.make_sharded_prune_step(t.jqd, t.jm)(
        st, jnp.asarray(packed), jnp.asarray(ok))
    pos, val = host.delta_encode(ref_codes, ok, t.base)
    got = pmesh.make_sharded_prune_step(t.qd, t.pm)(pst, _t(packed), _t(ok))
    got_d = pmesh.make_sharded_prune_step(t.qd, t.pm, delta=True)(
        pst, _t(pos), _t(val), _t(ok))
    one = scan.prune_step(t.qd1, pst, _t(ref_codes), _t(ok))
    for g in (got, got_d, one):
        _equal(g, want)


@pytest.mark.parametrize("acgt", [False, True])
def test_sharded_survivor_buffers_equal_dense(acgt):
    """The sharded survivor path (prune_acc + flush, packed and delta
    batches) lands the JAX mesh's state and flags at every flush, and
    the dense one-device state at the end."""
    rng = np.random.default_rng(31)
    L, k, B, n_db = 520, 3, 16, 4
    pack = _build(rng, acgt, L=L)
    ref_codes = np.stack([encode(r) for r in random_alignment(rng, 64, L)])
    t = _Three(pack, k, (n_db, 2), prune=True)
    cap_loc = 2 * (B // n_db)
    jinit, jacc, jacc_d, jflush = jmesh.make_sharded_survivor_ops(
        t.jqd, t.jm, cap_loc)
    pinit, pacc, pacc_d, pflush = pmesh.make_sharded_survivor_ops(
        t.qd, t.pm, cap_loc)
    jb, pb = jinit(), pinit()
    js, ps, p1 = t.init()
    flagged, n_flush = set(), 0
    for start in range(0, 64, B):
        batch = ref_codes[start:start + B]
        ok = np.ones(B, dtype=bool)
        ridx = start + np.arange(B, dtype=np.int32)
        if start % (2 * B) == 0:
            packed = host.pack_codes(batch)
            jsv, jb = jacc(js, jb, jnp.asarray(packed), jnp.asarray(ok),
                           jnp.asarray(ridx))
            psv, pb = pacc(ps, pb, _t(packed), _t(ok), _t(ridx))
        else:
            pos, val = host.delta_encode(batch, ok, t.base)
            jsv, jb = jacc_d(js, jb, jnp.asarray(pos), jnp.asarray(val),
                             jnp.asarray(ok), jnp.asarray(ridx))
            psv, pb = pacc_d(ps, pb, _t(pos), _t(val), _t(ok), _t(ridx))
        _equal(psv, jsv)
        _equal(pb.fill(), jb[2])
        if int(pb.fill().max()) + B // n_db > cap_loc:
            js, jb, ps, pb, got = _flush(jflush, js, jb, pflush, ps, pb)
            flagged |= got
            n_flush += 1
        p1, _ = scan.scan_step(t.qd1, p1, _t(batch), _t(ok), start)
    js, jb, ps, pb, got = _flush(jflush, js, jb, pflush, ps, pb)
    flagged |= got
    assert n_flush >= 1
    _state_equal(ps, p1)
    final = set(p1[1].numpy().ravel().tolist()) - {int(scan._SENT)}
    assert final <= flagged


def _flush(jflush, js, jb, pflush, ps, pb):
    """One flush of both packages: flags, fills and states equal; the
    flagged global indices."""
    j_idx, p_idx = np.asarray(jb[1]), pb.indices()
    js, jfl, jb = jflush(js, jb)
    ps, pfl, pb = pflush(ps, pb)
    _equal(pfl, jfl)
    _equal(p_idx[pfl.numpy()], j_idx[np.asarray(jfl)])
    _equal(pb.fill(), jb[2])
    _state_equal(ps, js)
    return js, jb, ps, pb, {int(i) for i in p_idx[pfl.numpy()]}


def _files(rng, L=400, nq=6, nr=150):
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    write_fasta("db.fa", [f"r{i}" for i in range(nr)],
                random_seqs(rng, nr, L))


def _same(a, b):
    for ext in (".csv.xz", ".aln.xz"):
        assert filecmp.cmp(a + ext, b + ext, shallow=False), a + ext


@pytest.mark.parametrize("prune", [False, True])
def test_sharded_nearest_end_to_end_equals_single(tmp_path, monkeypatch,
                                                  prune):
    """run_nearest over an 8-shard (4 x 2) CPU mesh writes uvaia_tpu's
    sharded CSV and dump bytes, and the one-device CSV."""
    monkeypatch.chdir(tmp_path)
    _files(np.random.default_rng(29))
    k = 5
    jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
        nbest=k, pool=32, output="single", prune=False))
    jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
        nbest=k, pool=32, output="jshard", n_devices=8, site_shards=2,
        prune=prune))
    res = pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
        nbest=k, pool=32, output="pshard", n_devices=8, site_shards=2,
        prune=prune, device="cpu"))
    _same("jshard", "pshard")
    assert filecmp.cmp("single.csv.xz", "pshard.csv.xz", shallow=False)
    assert res.n_saved > 0


@pytest.mark.parametrize("prune", [True, False])
def test_port_resumes_jax_sharded_checkpoint(tmp_path, monkeypatch, prune):
    """uvaia_tpu's sharded run crashes after a checkpoint; the port's
    sharded run resumes the same snapshot to the bytes uvaia_tpu's own
    resume writes, and to the uninterrupted table."""
    monkeypatch.chdir(tmp_path)
    _files(np.random.default_rng(83), nr=120)
    import uvaia_tpu.parallel.mesh as jm_mod
    target = "make_sharded_survivor_ops" if prune else \
        "make_sharded_scan_step"
    orig = getattr(jm_mod, target)
    count = {"n": 0}

    class _Boom(RuntimeError):
        pass

    def crashing(fn):
        def run(*x, **y):
            if count["n"] >= 2:
                raise _Boom("simulated crash")
            count["n"] += 1
            return fn(*x, **y)
        return run

    def crashing_ops(*a, **kw):
        if not prune:                  # the dense step itself
            return crashing(orig(*a, **kw))
        *ops, flush = orig(*a, **kw)
        return (*ops, crashing(flush))

    monkeypatch.setattr(jm_mod, target, crashing_ops)
    kw = dict(nbest=5, pool=16, prune=prune, checkpoint="c.ckpt",
              output="jres", n_devices=4, site_shards=2)
    with pytest.raises(_Boom):
        jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
            checkpoint_every=0.0, **kw))
    monkeypatch.setattr(jm_mod, target, orig)
    shutil.copy("c.ckpt", "p.ckpt")
    shutil.copy("jres.aln.xz", "pres.aln.xz")
    jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
        checkpoint_every=1e9, **kw))
    kw.update(checkpoint="p.ckpt", output="pres", device="cpu")
    pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
        checkpoint_every=1e9, **kw))
    _same("jres", "pres")
    pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
        nbest=5, pool=16, prune=prune, output="full", device="cpu"))
    assert filecmp.cmp("full.csv.xz", "pres.csv.xz", shallow=False)


def test_make_mesh_devices():
    """local_devices: n CPU shards on the one CPU device; a CUDA mesh
    larger than the visible cards is refused with the JAX package's
    message."""
    m = pmesh.make_mesh(4, 2, device_type="cpu")
    assert m.shape == {"db": 4, "site": 2}
    assert m.lead == torch.device("cpu")
    assert all(d == torch.device("cpu") for row in m.devices for d in row)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            pmesh.make_mesh(2, 1)
