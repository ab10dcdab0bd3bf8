"""`ball` and `legacy` end to end: the port (uvaia_tpu_torch, on the
CPU) against the JAX package (uvaia_tpu) on the same files, at the
scenarios of tests/test_tools.py.  The kept `.aln` bytes, the returned
counts, the printed table and the saved references must be equal; the
score store's integer counters exactly, its weighted partial to rtol
1e-6 (float32 rounding of the JAX package's sum, see
tests/test_torch_distance.py).
"""

import filecmp

import numpy as np
import pytest

import uvaia_tpu.engine.ball as jball
import uvaia_tpu.engine.legacy as jlegacy
from uvaia_tpu.core.encoding import encode
from uvaia_tpu.io.fasta import read_fasta_all
from uvaia_tpu.io.store import ingest
from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.engine import ball as pball
from uvaia_tpu_torch.engine import legacy as plegacy
from uvaia_tpu_torch.engine.query import build_query_pack
from uvaia_tpu_torch.ops import recon

from test_nearest import random_seqs, write_fasta
from test_tools import ball_oracle, staged_ball_oracle


def _ball_both(refs, query="q.fa", **kw):
    jres = jball.run_ball(refs, query, jball.BallConfig(output="jax", **kw))
    pres = pball.run_ball(refs, query, pball.BallConfig(
        output="port", device="cpu", **kw))
    suffix = {"xz": ".xz", "raw": ""}[kw.get("codec", "xz")]
    assert filecmp.cmp("jax.aln" + suffix, "port.aln" + suffix,
                       shallow=False)
    steps = pres.pop("steps")
    assert pres == jres
    return pres, steps


@pytest.mark.parametrize("acgt", [False, True])
def test_ball_close_to_bruteforce(tmp_path, monkeypatch, acgt):
    """One query (consensus == query): both packages keep what brute
    force keeps."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(21)
    seqs = random_seqs(rng, 30, 400, mut=0.01)
    write_fasta("q.fa", ["q0"], seqs[:1])
    write_fasta("db.fa", [f"r{i}" for i in range(29)], seqs[1:])
    res, steps = _ball_both(["db.fa"], distance=4, acgt=acgt, pool=8)
    kept = {r.name for r in read_fasta_all("port.aln.xz")}
    expect = ball_oracle(seqs[1:], seqs[:1], 4, acgt)
    assert kept == {f"r{i}" for i, k in enumerate(expect) if k}
    assert res["kept"] == len(kept) and steps["delta"] == 4


def _staged_files():
    """The crafted queries and references of tests/test_tools.py's
    staged-semantics scenario: refs at every decision boundary."""
    L = 400
    backbone = np.frombuffer(b"ACGT" * (L // 4), dtype=np.uint8).copy()
    backbone[:30] = ord("A")

    def with_muts(base, muts):
        s = base.copy()
        for pos, ch in muts:
            s[pos] = ord(ch)
        return s

    qs = []
    for i in range(4):
        muts = [(p, "C") for p in range(12)] if i >= 2 else []
        muts += [(20 + i, "CGTC"[i])]
        q = with_muts(backbone, muts)
        if i == 0:
            q[100:110] = ord("N")
        qs.append(q)
    write_fasta("q.fa", [f"q{i}" for i in range(4)],
                [q.tobytes().decode() for q in qs])

    def cmut(j):
        p = 200 + j
        return (p, "CGTA"["ACGT".index(chr(backbone[p]))])

    mmut = (105, "T")
    poly_g = [(p, "G") for p in range(12)]
    refs = {
        "r_quirk": with_muts(backbone, poly_g),
        "r_short2": with_muts(backbone, poly_g + [cmut(0), cmut(1)]),
        "r_edge_keep": with_muts(backbone, [(0, "G"), (1, "G"), (20, "C")]
                                 + [cmut(j) for j in range(3)]),
        "r_edge_drop": with_muts(backbone,
                                 [(0, "G"), (1, "G"), (2, "G"), (20, "C")]
                                 + [cmut(j) for j in range(3)]),
        "r_m_keep": with_muts(backbone, [(20, "C"), mmut]
                              + [cmut(j) for j in range(4)]),
        "r_m_drop": with_muts(backbone, [(20, "C"), mmut]
                              + [cmut(j) for j in range(5)]),
        "r_q2": with_muts(backbone, [(p, "C") for p in range(12)]
                          + [(22, "T")] + [cmut(j) for j in range(4)]),
    }
    write_fasta("db.fa", list(refs),
                [r.tobytes().decode() for r in refs.values()])
    return refs


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("acgt", [False, True])
def test_ball_multiquery_staged_semantics(tmp_path, monkeypatch, acgt,
                                          store):
    """Four queries sharing a consensus: the keep rule with the skipped
    stage 3, from a FASTA database and from an ingested store."""
    monkeypatch.chdir(tmp_path)
    refs = _staged_files()
    db = "db.fa"
    if store:
        ingest(["db.fa"], "db.uvst")
        db = "db.uvst"
    res, _ = _ball_both([db], distance=5, acgt=acgt, pool=4)
    kept = {r.name for r in read_fasta_all("port.aln.xz")}
    pack = build_query_pack("q.fa", acgt=acgt, always_exclude_redundant=True)
    assert pack.n_query == 4
    expect = staged_ball_oracle([encode(r) for r in refs.values()],
                                list(pack.codes), pack.idx_c, pack.idx_m,
                                pack.idx, pack.consensus, 5, acgt)
    assert kept == {n for n, k in zip(refs, expect) if k}
    assert {"r_quirk", "r_short2", "r_edge_keep", "r_m_keep", "r_q2"} <= kept
    assert {"r_edge_drop", "r_m_drop"}.isdisjoint(kept)
    assert res["kept"] == len(kept)


def _ball_files(L=600, nq=5, nr=70, seed=8):
    rng = np.random.default_rng(seed)
    seqs = random_seqs(rng, nq + nr, L, mut=0.004)    # one backbone
    qs, refs = seqs[:nq], seqs[nq:]
    qs.append(qs[0][:40] + "N" * 30 + qs[0][70:])     # redundant copy
    write_fasta("q.fa", [f"q{i}" for i in range(len(qs))], qs)
    refs[3] = "N" * (L - 100) + refs[3][L - 100:]     # too ambiguous
    write_fasta("db.fa", [f"r{i}" for i in range(nr)], refs)


@pytest.mark.parametrize("kw", [
    dict(), dict(acgt=True), dict(keep_resolved=True), dict(trim=25),
    dict(distance=0), dict(distance=10 ** 6),        # clamped to L / 10
    dict(query_ambiguity=0.0, ref_ambiguity=7.0),    # both clamps
    dict(codec="raw"), dict(pool=7)], ids=str)
def test_ball_options_match_jax(tmp_path, monkeypatch, kw):
    monkeypatch.chdir(tmp_path)
    _ball_files()
    args = dict(distance=3, pool=16)
    args.update(kw)
    res, _ = _ball_both(["db.fa"], **args)
    assert res["count"] == 70
    if not kw or kw.get("ref_ambiguity"):
        assert res["invalid"] == (0 if kw else 1) and res["kept"] > 0


def test_ball_packed_and_delta_steps(tmp_path, monkeypatch):
    """A batch holding a row that differs from the base at more sites
    than the largest delta bucket goes up 4-bit packed; the others as
    deltas through the rebuild."""
    monkeypatch.chdir(tmp_path)
    L = 6000
    rng = np.random.default_rng(3)
    seqs = random_seqs(rng, 25, L, mut=0.002)
    write_fasta("q.fa", ["q0", "q1"], seqs[:2])
    far = "".join(rng.choice(list("ACGT"), L))
    refs = seqs[2:12] + [far] + seqs[12:]
    write_fasta("db.fa", [f"r{i}" for i in range(len(refs))], refs)
    res, steps = _ball_both(["db.fa"], distance=40, pool=8)
    assert steps == {"delta": 2, "packed": 1}
    assert 0 < res["kept"] < len(refs)
    assert "r10" not in {r.name for r in read_fasta_all("port.aln.xz")}


def test_ball_refuses_mixed_inputs_and_closes_the_writer(tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    _ball_files(nr=20)
    ingest(["db.fa"], "db.uvst")
    with pytest.raises(SystemExit, match="mix ingested stores"):
        pball.run_ball(["db.uvst", "db.fa"], "q.fa",
                       pball.BallConfig(device="cpu"))
    # a database row of another length stops the run; what was kept so
    # far is flushed all the same
    with open("db.fa", "a") as f:
        f.write(">short\nACGT\n")
    for pkg, cfg in ((jball, {}), (pball, {"device": "cpu"})):
        with pytest.raises(SystemExit):
            pkg.run_ball(["db.fa"], "q.fa", pkg.BallConfig(
                distance=50, pool=8, output=pkg.__name__, **cfg))
    assert filecmp.cmp(jball.__name__ + ".aln.xz", pball.__name__ + ".aln.xz",
                       shallow=False)


def test_ball_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _ball_files(nr=30)
    jball.run_ball(["db.fa"], "q.fa", jball.BallConfig(
        distance=3, acgt=True, keep_resolved=True, trim=10, pool=16,
        output="jax"))
    before = recon.delta_rebuild.launches
    assert port_main(["ball", "-r", "db.fa", "q.fa", "-d", "3", "-x", "-k",
                      "--trim", "10", "-p", "16", "-o", "port",
                      "--device", "cpu"]) == 0
    assert recon.delta_rebuild.launches == before     # plain version: no launch
    assert filecmp.cmp("jax.aln.xz", "port.aln.xz", shallow=False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["ball", "-r", "db.fa", "q.fa"])


# ----------------------------------------------------------------------
# legacy


def _legacy_both(capsys, ref, query="q.fa", **kw):
    capsys.readouterr()
    save = kw.pop("save", True)
    jres = jlegacy.run_legacy(ref, query, jlegacy.LegacyConfig(
        output="jax" if save else None, **kw))
    jout = capsys.readouterr().out
    pres = plegacy.run_legacy(ref, query, plegacy.LegacyConfig(
        output="port" if save else None, device="cpu", **kw))
    pout = capsys.readouterr().out
    assert pout == jout
    (s0, s1, s2, s3), qn, rn = pres
    (j0, j1, j2, j3), jqn, jrn = jres
    assert (qn, rn) == (jqn, jrn)
    for a, b in ((s0, j0), (s1, j1), (s3, j3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(s2, j2, rtol=1e-6)
    return pres[0], pout


def test_legacy_table_and_save(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(41)
    seqs = random_seqs(rng, 8, 240, mut=0.02)
    write_fasta("db.fa", [f"r{i}" for i in range(6)], seqs[:6])
    write_fasta("q.fa", ["qq"], [seqs[0]])
    _, out = _legacy_both(capsys, "db.fa", nbest=2)
    rows = [l.split(",") for l in out.strip().split("\n")[1:]]
    assert rows[0][1].strip() == "r0"
    assert filecmp.cmp("jax.fa.xz", "port.fa.xz", shallow=False)


def test_legacy_long_alignment_no_uint16_wrap(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(42)
    L = 70_000
    base = "".join(rng.choice(list("ACGT"), L))
    write_fasta("db.fa", ["r0", "r1"], [base, "N" * 50 + base[50:]])
    write_fasta("q.fa", ["qq"], [base])
    (s0, *_), out = _legacy_both(capsys, "db.fa", nbest=1, save=False)
    assert s0.dtype == np.int32 and s0[0, 0] == L
    rows = [l.split(",") for l in out.strip().split("\n")[1:]]
    assert int(float(rows[0][2])) == L and int(float(rows[0][3])) == L


def _legacy_files(nr=70, L=500, seed=9):
    """Enough references for all three stages (n > 32), ambiguity codes
    on every row, one reference and one query that fail QC, one query of
    another length."""
    rng = np.random.default_rng(seed)
    seqs = random_seqs(rng, nr + 3, L, mut=0.05)
    refs = seqs[:nr]
    refs[5] = "N" * (L - 60) + refs[5][L - 60:]
    write_fasta("db.fa", [f"r{i}" for i in range(nr)], refs)
    write_fasta("q.fa", ["qa", "qb", "bad", "short"],
                [seqs[nr], seqs[nr + 1], "N" * L, seqs[nr + 2][:L - 7]])


@pytest.mark.parametrize("kw", [
    dict(), dict(nbest=3, nmax=4), dict(nbest=0), dict(trim=40),
    dict(trim=10 ** 6), dict(partial_rule="jaccard"),
    dict(partial_rule="max"), dict(batch=16),
    dict(ambiguity=7.0, ref_ambiguity=9.0)], ids=str)
def test_legacy_options_match_jax(tmp_path, monkeypatch, capsys, kw):
    monkeypatch.chdir(tmp_path)
    _legacy_files()
    (s0, *_), out = _legacy_both(capsys, "db.fa", **kw)
    assert s0.shape[1] == (3 if kw.get("ambiguity") else 2)
    assert len(out.strip().split("\n")) > 2 * max(kw.get("nbest", 8), 1)
    assert filecmp.cmp("jax.fa.xz", "port.fa.xz", shallow=False)


def test_legacy_store_input_matches_jax(tmp_path, monkeypatch, capsys):
    """The store QC branch: the same table, scores and saved bytes from
    an ingested store as from the FASTA it was made of."""
    monkeypatch.chdir(tmp_path)
    _legacy_files()
    ingest(["db.fa"], "db.uvst")
    _, from_fasta = _legacy_both(capsys, "db.fa", nbest=4)
    saved = open("port.fa.xz", "rb").read()
    _, from_store = _legacy_both(capsys, "db.uvst", nbest=4)
    assert from_store == from_fasta
    assert open("port.fa.xz", "rb").read() == saved


def test_legacy_cli_and_empty_inputs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _legacy_files(nr=40)
    jlegacy.run_legacy("db.fa", "q.fa", jlegacy.LegacyConfig(
        nbest=3, nmax=5, trim=12, partial_rule="max", output="jax.fa.xz"))
    jout = capsys.readouterr().out
    assert port_main(["legacy", "-r", "db.fa", "q.fa", "-n", "3", "-m", "5",
                      "--trim", "12", "--partial-rule", "max", "-o",
                      "port.fa.xz", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jout
    assert filecmp.cmp("jax.fa.xz", "port.fa.xz", shallow=False)
    write_fasta("none.fa", ["x"], ["N" * 500])
    for args in (("none.fa", "q.fa"), ("db.fa", "none.fa")):
        with pytest.raises(SystemExit, match="No valid"):
            plegacy.run_legacy(*args, plegacy.LegacyConfig(device="cpu"))
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["legacy", "-r", "db.fa", "q.fa"])
