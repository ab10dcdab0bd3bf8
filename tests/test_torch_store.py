"""`ingest`, `info` and `verify`: the port (uvaia_tpu_torch.io.store)
against the JAX package (uvaia_tpu.io.store) on the same FASTA, at the
scenarios of tests/test_store.py.  Every file of the two store
directories must be equal byte for byte, with the native one-pass block
digest and with the numpy digest (``UVAIA_TPU_NO_NATIVE=1``); `info`
and `verify` must report the same; and each package reads the other's
stores.

tests/test_store.py:276 (a store scanned by the 8-device sharded path)
has no counterpart here: ``--devices`` is not ported yet.
"""

import json
import os

import numpy as np
import pytest

import uvaia_tpu.io.native as jnative
import uvaia_tpu.io.store as jstore
from uvaia_tpu.cli import main as jax_cli
from uvaia_tpu.engine import nearest as jnearest
from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.core.encoding import ENCODE_LUT
from uvaia_tpu_torch.engine import nearest as pnearest
from uvaia_tpu_torch.engine.stream import (RefStreamer, dump_entries,
                                           dump_entry)
from uvaia_tpu_torch.io import native as pnative
from uvaia_tpu_torch.io import store as pstore
from uvaia_tpu_torch.utils import observe

from test_store import _mk_genomes, _write_fasta


def _same_dirs(a, b):
    """Every file of store directory `a` equals its namesake in `b`."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        assert open(os.path.join(a, f), "rb").read() == \
            open(os.path.join(b, f), "rb").read(), f


@pytest.fixture(params=["native", "numpy"])
def digest(request, monkeypatch):
    """Both packages with their native library (the one-pass block
    digest) or without it, as ``UVAIA_TPU_NO_NATIVE=1`` runs them."""
    if request.param == "numpy":
        monkeypatch.setenv("UVAIA_TPU_NO_NATIVE", "1")
        for mod in (jnative, pnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_failed", False)
        assert pnative.get_lib() is None
        assert jstore._store_block_lib() is None
    else:
        assert pnative.get_lib() is not None
    return request.param


def _ingest_both(paths, tmp_path, tag, **kw):
    """(jax store, port store) from the same inputs; byte-equal."""
    j, p = str(tmp_path / f"jax_{tag}.uvst"), str(tmp_path / f"port_{tag}.uvst")
    sj = jstore.ingest([str(x) for x in paths], j, **kw)
    sp = pstore.ingest([str(x) for x in paths], p, **kw)
    _same_dirs(j, p)
    for f in ("n_rows", "n_sites", "n_delta_blocks", "n_packed_blocks",
              "bytes"):
        assert getattr(sp, f) == getattr(sj, f), f
    return j, p


def _genomes(tmp_path, scenario):
    """(fasta path, names, sequences, ingest kwargs) of one scenario."""
    rng = np.random.default_rng(7)
    if scenario in ("roundtrip", "no_frames"):
        # tests/test_store.py:70 (the shared fixture) and :346
        names = [f"seq_{i:03d}|x" for i in range(37)]
        seqs = _mk_genomes(rng, 37, 600)
        kw = dict(block=8, frames=scenario == "roundtrip")
    elif scenario == "packed_only":
        # tests/test_store.py:311: half the rows overflow every delta
        # bucket, so one block is stored packed-only
        L = 6000
        alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
        backbone = alphabet[rng.integers(0, 4, size=L)]
        seqs = []
        for i in range(12):
            s = backbone.copy() if i < 6 else \
                alphabet[rng.integers(0, 4, size=L)]
            if i < 6:
                mut = rng.random(L) < 0.01
                s[mut] = alphabet[rng.integers(0, 4, size=mut.sum())]
            seqs.append(s.tobytes())
        names = [f"g{i}" for i in range(12)]
        kw = dict(block=6)
    else:
        # tests/test_store.py:660: the full IUPAC set, gaps, exception
        # characters and lowercase at an odd L
        alphabet = np.frombuffer(b"ACGTRYSWKMBDHVN-acgtryn?U*.",
                                 dtype=np.uint8)
        rows = alphabet[rng.integers(0, len(alphabet), size=(23, 257))]
        seqs = [r.tobytes() for r in rows]
        names = [f"w{i}|odd name (x){i}" for i in range(23)]
        kw = dict(block=7, frames=True)
    fa = tmp_path / "db.fa.xz"
    _write_fasta(fa, names, seqs)
    return fa, names, seqs, kw


@pytest.mark.parametrize("scenario", ["roundtrip", "no_frames",
                                      "packed_only", "arbitrary_bytes"])
def test_ingest_matches_jax(tmp_path, digest, scenario):
    """The same store, file for file; the port's Store decodes every row
    of it exactly (names, bytes, codes, valid counts, dump frames)."""
    fa, names, seqs, kw = _genomes(tmp_path, scenario)
    j, p = _ingest_both([fa], tmp_path, "db", **kw)
    st, sj = pstore.Store(p), jstore.Store(j)
    assert st.n_rows == len(names) and pstore.is_store(p)
    assert not pstore.is_store(str(fa))
    info = pstore.info(p)
    if scenario == "packed_only":
        assert info["n_packed_only_blocks"] >= 1
        assert info["n_delta_blocks"] >= 1
    assert info["has_rowxz"] == kw.get("frames", False)
    for r in range(st.n_rows):
        want = seqs[r].upper()
        assert st.name(r) == names[r]
        assert st.seq_row(r) == want, f"row {r}"
        codes = ENCODE_LUT[np.frombuffer(want, dtype=np.uint8)]
        np.testing.assert_array_equal(st.codes_row(r), codes)
        assert st.valid[r] == np.count_nonzero(codes)
        assert st.frame_row(r) == sj.frame_row(r)
    assert pstore.verify(p) == jstore.verify(j)
    assert pstore.verify(p)["ok"]


@pytest.mark.parametrize("scenario", ["roundtrip", "no_frames",
                                      "packed_only", "arbitrary_bytes"])
def test_seq_rows_match_seq_row(tmp_path, digest, scenario):
    """`Store.seq_rows` (one native call, or `seq_row` row by row
    without the library) decodes all rows, an unsorted subset with
    repeats and no rows as `seq_row` does, gap runs, exceptions and odd
    lengths included; `bulk_decode_rows` counts the native rows."""
    fa, _, seqs, kw = _genomes(tmp_path, scenario)
    p = str(tmp_path / "port.uvst")
    pstore.ingest([str(fa)], p, **kw)
    st = pstore.Store(p)
    st._lazy_decode_meta()
    if scenario != "packed_only":
        assert (np.diff(st._run_off) > 0).any()
        assert (np.diff(st._exc_off) > 0).any()
    if scenario == "arbitrary_bytes":
        assert st.n_sites % 2 == 1
    picks = np.random.default_rng(5).integers(0, st.n_rows, 3 * st.n_rows)
    assert (np.diff(picks) < 0).any() and len(set(picks)) < len(picks)
    with observe.job("decode") as job:
        for rows in (range(st.n_rows), picks, [], picks[::-2]):
            want = [st.seq_row(int(r)) for r in rows]
            assert st.seq_rows(rows) == want
            assert want == [seqs[r].upper() for r in rows]
        with pytest.raises(IndexError):
            st.seq_rows([0, st.n_rows])
    native_rows = st.n_rows + len(picks) + len(picks[::-2])
    assert job.counts.get("bulk_decode_rows", 0) == (
        native_rows if digest == "native" else 0)
    if digest == "native":
        # offsets past their section never reach the library
        bad = pstore.Store(p)
        bad._lazy_decode_meta()
        bad._exc_off = bad._exc_off + len(bad._exc_pos) + 1
        with pytest.raises(ValueError, match="damaged row offsets"):
            bad.seq_rows([0])


@pytest.mark.parametrize("kind", ["store", "frames", "fasta"])
def test_dump_entries_equal_dump_entry(tmp_path, digest, kind):
    """`dump_entries(batch, idx)` is the per-row `dump_entry` list on a
    store batch, a store batch with dump frames and a FASTA batch (raw
    rows with the library, sequences without)."""
    fa, names, _, kw = _genomes(
        tmp_path, "roundtrip" if kind == "frames" else "no_frames")
    n_sites = 600
    if kind == "fasta":
        streamer = RefStreamer([str(fa)], n_sites, 16)
    else:
        p = str(tmp_path / "port.uvst")
        pstore.ingest([str(fa)], p, **kw)
        streamer = pstore.StoreStreamer([p], n_sites, 16)
    rng = np.random.default_rng(9)
    seen = 0
    for batch in streamer:
        batch = batch[0] if isinstance(batch, tuple) else batch
        if kind != "fasta":
            # pieces of two store blocks (block=8) in a batch of 16
            assert len(batch.pieces) >= 2 or batch.n <= 8
        idx = rng.permutation(batch.n)[: batch.n - 1]
        idx = np.concatenate([idx, idx[:3]])
        got = dump_entries(batch, idx)
        assert got == [dump_entry(batch, int(i)) for i in idx]
        assert dump_entries(batch, []) == []
        frames = [f is not None for _, _, f in got]
        assert all(frames) if kind == "frames" else not any(frames)
        seen += batch.n
    assert seen == len(names) > 16


def test_append_equals_jax_append(tmp_path, digest):
    """tests/test_store.py:370: ingest(A) then --append(B) is the JAX
    package's store byte for byte, and holds the rows of ingest(A+B)."""
    rng = np.random.default_rng(31)
    seqs = _mk_genomes(rng, 41, 600)
    names = [f"s{i:03d}" for i in range(41)]
    fa_a, fa_b = tmp_path / "a.fa.xz", tmp_path / "b.fa.xz"
    _write_fasta(fa_a, names[:23], seqs[:23])
    _write_fasta(fa_b, names[23:], seqs[23:])
    j_one, p_one = _ingest_both([fa_a, fa_b], tmp_path, "one", block=8,
                                frames=True)
    j, p = _ingest_both([fa_a], tmp_path, "two", block=8, frames=True)
    sj = jstore.ingest([str(fa_b)], j, block=8, append=True)
    sp = pstore.ingest([str(fa_b)], p, block=8, append=True)
    assert sp.n_rows == sj.n_rows == 18
    _same_dirs(j, p)
    s1, s2 = pstore.Store(p_one), pstore.Store(p)
    assert s2.n_rows == s1.n_rows == 41
    assert s2.meta["has_rowxz"] and s2.meta["has_delta"]
    np.testing.assert_array_equal(np.asarray(s1.packed),
                                  np.asarray(s2.packed))
    for r in range(41):
        assert s2.name(r) == s1.name(r) == names[r]
        assert s2.seq_row(r) == s1.seq_row(r)
        assert s2.frame_row(r) == s1.frame_row(r)


def test_append_crash_rerun_matches_jax(tmp_path):
    """tests/test_store.py:417: an append whose meta commit was lost
    leaves the old store readable, and its rerun gives the clean append
    of either package byte for byte (the orphans truncated)."""
    rng = np.random.default_rng(37)
    seqs = _mk_genomes(rng, 30, 600)
    names = [f"c{i:03d}" for i in range(30)]
    fa_a, fa_b = tmp_path / "a.fa.xz", tmp_path / "b.fa.xz"
    _write_fasta(fa_a, names[:17], seqs[:17])
    _write_fasta(fa_b, names[17:], seqs[17:])
    two = tmp_path / "two.uvst"
    pstore.ingest([str(fa_a)], str(two), block=8, frames=True)
    meta_before = (two / "meta.json").read_bytes()
    pstore.ingest([str(fa_b)], str(two), block=8, append=True)
    (two / "meta.json").write_bytes(meta_before)
    st = pstore.Store(str(two))
    assert st.n_rows == 17 and st.seq_row(16) == seqs[16].upper()
    pstore.ingest([str(fa_b)], str(two), block=8, append=True)
    three = tmp_path / "three.uvst"
    jstore.ingest([str(fa_a)], str(three), block=8, frames=True)
    jstore.ingest([str(fa_b)], str(three), block=8, append=True)
    _same_dirs(str(three), str(two))


def test_append_guards_and_overwrite_match_jax(tmp_path):
    """tests/test_store.py:472 and :485: --append needs an existing store
    of the same site count; a plain ingest never overwrites."""
    rng = np.random.default_rng(3)
    fa = tmp_path / "db.fa"
    _write_fasta(fa, ["a", "b"], _mk_genomes(rng, 2, 120))
    short = tmp_path / "short.fa"
    _write_fasta(short, ["x"], ["ACGT"])
    dst = str(tmp_path / "st.uvst")
    for mod in (jstore, pstore):
        with pytest.raises(SystemExit, match="existing store"):
            mod.ingest([str(fa)], str(tmp_path / "nope.uvst"), append=True)
    pstore.ingest([str(fa)], dst, block=8)
    for mod in (jstore, pstore):
        with pytest.raises(SystemExit, match="aligned"):
            mod.ingest([str(short)], dst, append=True)
        with pytest.raises(SystemExit, match="exists"):
            mod.ingest([str(fa)], dst)
    assert pstore.is_store(dst) and pstore.verify(dst)["ok"]


def test_info_matches_jax(tmp_path, capsys):
    """tests/test_store.py:491: `info` as a function and through both
    command lines, in text and JSON, with and without --verify."""
    fa, names, _, kw = _genomes(tmp_path, "roundtrip")
    j, p = _ingest_both([fa], tmp_path, "db", **kw)
    rec = pstore.info(p)
    want = jstore.info(j)
    assert rec == want
    assert rec["n_rows"] == len(names) and rec["n_sites"] == 600
    assert rec["total_bytes"] == sum(rec["component_bytes"].values()) > 0
    assert str(fa) in rec["sources"]
    with pytest.raises(ValueError):
        pstore.info(str(tmp_path))
    capsys.readouterr()
    for flags in ([], ["--json"], ["--verify"], ["--verify", "--json"]):
        assert jax_cli.main(["info", j, *flags]) == 0
        out_j = capsys.readouterr().out.replace(j, "STORE")
        assert port_main(["info", p, *flags]) == 0
        out_p = capsys.readouterr().out.replace(p, "STORE")
        assert out_p == out_j
        if "--json" in flags:
            assert {k: v for k, v in json.loads(out_p).items()
                    if k != "verify"} == rec
    with pytest.raises(SystemExit, match="not a committed"):
        port_main(["info", str(tmp_path)])


def _flip(path, at, mask):
    with open(path, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ mask]))


def _corrupt(d, what):
    """Damage one section of store `d` (tests/test_store.py:525, :617)."""
    blocks = np.load(os.path.join(d, "blocks.npy"))
    w2 = json.load(open(os.path.join(d, "meta.json")))["w2"]
    if what == "packed":
        _flip(os.path.join(d, "packed.bin"), int(blocks[1, 0]) * w2 + 3,
              0x11)
    elif what == "delta_pos":
        assert int(blocks[0, 2]) > 0
        _flip(os.path.join(d, "delta_pos.bin"), int(blocks[0, 3]) + 1, 0x40)
    elif what.endswith(".bin"):
        _flip(os.path.join(d, what), 2, 0x01)
    elif what == "valid":
        v = np.load(os.path.join(d, "valid.npy"))
        v[5] ^= 1
        np.save(os.path.join(d, "valid.npy"), v)
    elif what == "name_offsets":
        np.save(os.path.join(d, "name_offsets.npy"),
                np.empty(0, dtype=np.int64))
    elif what == "missing_delta":
        os.unlink(os.path.join(d, "delta_pos.bin"))


@pytest.mark.parametrize("what", [
    "packed", "delta_pos", "names.bin", "gapruns.bin", "exc_chr.bin",
    "rowxz.bin", "valid", "name_offsets", "missing_delta"])
def test_verify_detects_corruption_like_jax(tmp_path, capsys, what):
    """The same damage to a port store and a JAX store: the same verify
    report, never ok; `info --verify` exits 1 in text and JSON."""
    fa, _, _, kw = _genomes(tmp_path, "roundtrip")
    j, p = _ingest_both([fa], tmp_path, "db", **kw)
    for d in (j, p):
        _corrupt(d, what)
    rep = pstore.verify(p)
    assert rep == jstore.verify(j)
    assert not rep["ok"] and (rep["bad_blocks"] or rep["errors"])
    if what == "packed":
        assert rep["bad_blocks"] == [1]
    capsys.readouterr()
    assert port_main(["info", p, "--verify"]) == 1
    assert "CORRUPT" in capsys.readouterr().out
    assert port_main(["info", p, "--verify", "--json"]) == 1
    assert json.loads(capsys.readouterr().out)["verify"] == rep


def test_verify_after_append_and_without_checksums(tmp_path):
    """tests/test_store.py:569-588: an append extends the checksums; a
    store without block_crc.npy reports its blocks unknown, and an
    append to it checksums only the new block — as the JAX package."""
    fa, _, seqs, kw = _genomes(tmp_path, "roundtrip")
    j, p = _ingest_both([fa], tmp_path, "db", **kw)
    n0 = pstore.info(p)["n_blocks"]
    fa2 = str(tmp_path / "more.fa")
    _write_fasta(fa2, ["extra_a", "extra_b"], seqs[:2])
    for d, mod in ((j, jstore), (p, pstore)):
        mod.ingest([fa2], d, append=True)
    _same_dirs(j, p)
    rep = pstore.verify(p)
    assert rep["ok"] and rep["checked"] == n0 + 1
    for d, mod in ((j, jstore), (p, pstore)):
        os.unlink(os.path.join(d, "block_crc.npy"))
    rep = pstore.verify(p)
    assert rep == jstore.verify(j)
    assert rep["ok"] and rep["checked"] == 0 and rep["unknown"] == n0 + 1
    for d, mod in ((j, jstore), (p, pstore)):
        mod.ingest([fa2], d, append=True)
    _same_dirs(j, p)
    rep = pstore.verify(p)
    assert rep["ok"] and rep["checked"] == 1 and rep["unknown"] == n0 + 1


def test_each_package_reads_the_others_store(tmp_path, monkeypatch):
    """A port-written store through uvaia_tpu and a uvaia_tpu store
    through the port: exact rows, and `nearest` from either store gives
    the FASTA scan's CSV."""
    import lzma
    monkeypatch.chdir(tmp_path)
    fa, names, seqs, kw = _genomes(tmp_path, "roundtrip")
    pstore.ingest([str(fa)], "port.uvst", **kw)
    jstore.ingest([str(fa)], "jax.uvst", **kw)
    for st in (jstore.Store("port.uvst"), pstore.Store("jax.uvst")):
        for r in range(st.n_rows):
            assert st.name(r) == names[r]
            assert st.seq_row(r) == seqs[r].upper()
    _write_fasta("q.fa", names[:4], seqs[:4])
    runs = [(jnearest, [str(fa)], "fa", {}),
            (jnearest, ["port.uvst"], "j_on_p", {}),
            (pnearest, ["jax.uvst"], "p_on_j", {"device": "cpu"}),
            (pnearest, ["port.uvst"], "p_on_p", {"device": "cpu"})]
    for pkg, refs, out, extra in runs:
        pkg.run_nearest(refs, "q.fa", pkg.NearestConfig(
            nbest=6, pool=16, output=out, **extra))
    want = lzma.open("fa.csv.xz").read()
    for _, _, out, _ in runs[1:]:
        assert lzma.open(out + ".csv.xz").read() == want, out
