"""`nearest` end to end, in full mode and with --acgt: the port
(uvaia_tpu_torch, plain versions on the CPU) against the JAX package
(uvaia_tpu) on the same files.  The CSV and .aln dump bytes must be
equal."""

import filecmp
import lzma
import shutil

import numpy as np
import pytest

import uvaia_tpu.engine.nearest as jnearest
from uvaia_tpu.io.store import ingest
from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.engine import nearest as pnearest

from test_nearest import random_seqs, write_fasta


class _Boom(RuntimeError):
    pass


def _files(tmp_path, monkeypatch, nq=4, nr=120, L=500, seed=55):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(seed)
    qs = random_seqs(rng, nq, L)
    # a less resolved copy of q0: redundant under --keep_resolved
    qs.append(qs[0][:40] + "N" * 30 + qs[0][70:])
    write_fasta("q.fa", [f"q{i}" for i in range(len(qs))], qs)
    write_fasta("db.fa", [f"r{i}" for i in range(nr)],
                random_seqs(rng, nr, L, mut=0.05))


def _same_outputs(a: str, b: str) -> None:
    for ext in (".csv.xz", ".aln.xz"):
        assert filecmp.cmp(a + ext, b + ext, shallow=False), a + ext


def _run_both(refs, **kw):
    jres = jnearest.run_nearest(refs, "q.fa", jnearest.NearestConfig(
        nbest=6, pool=16, output="jax", **kw))
    pres = pnearest.run_nearest(refs, "q.fa", pnearest.NearestConfig(
        nbest=6, pool=16, output="port", device="cpu", **kw))
    _same_outputs("jax", "port")
    np.testing.assert_array_equal(pres.indices, jres.indices)
    np.testing.assert_array_equal(pres.scores, jres.scores)
    assert (pres.n_scanned, pres.n_saved) == (jres.n_scanned, jres.n_saved)
    return pres


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("trim", [0, 17])
def test_fasta_outputs_match_jax(tmp_path, monkeypatch, prune, trim):
    _files(tmp_path, monkeypatch)
    res = _run_both(["db.fa"], prune=prune, trim=trim)
    assert res.n_saved > 0


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("trim", [0, 17])
def test_acgt_fasta_outputs_match_jax(tmp_path, monkeypatch, prune, trim):
    _files(tmp_path, monkeypatch)
    res = _run_both(["db.fa"], prune=prune, trim=trim, acgt=True)
    assert res.n_saved > 0 and res.pack.acgt


@pytest.mark.parametrize("prune", [True, False])
def test_store_outputs_match_jax(tmp_path, monkeypatch, prune):
    """A store written by uvaia_tpu ingest, with --keep_resolved and
    --exclude_self on top."""
    _files(tmp_path, monkeypatch)
    ingest(["db.fa"], "db.uvst")
    res = _run_both(["db.uvst"], prune=prune, keep_resolved=True,
                    exclude_self=True)
    assert res.pack.n_query == 4          # the redundant copy is dropped


@pytest.mark.parametrize("prune", [True, False])
def test_acgt_store_outputs_match_jax(tmp_path, monkeypatch, prune):
    """--acgt on a store, with --keep_resolved (whose redundancy test
    counts pure sites only in this mode) and --exclude_self."""
    _files(tmp_path, monkeypatch)
    ingest(["db.fa"], "db.uvst")
    res = _run_both(["db.uvst"], prune=prune, keep_resolved=True,
                    exclude_self=True, acgt=True)
    assert res.pack.n_query == 4


@pytest.mark.parametrize("codec,suffix", [("bz2", ".bz2"), ("gz", ".gz"),
                                          ("raw", "")])
def test_codec_outputs_match_jax(tmp_path, monkeypatch, codec, suffix):
    """--codec: the decompressed CSV and dump equal the JAX package's
    (gzip stamps the time into its header, so compare the content)."""
    from uvaia_tpu.io.compress import open_read
    _files(tmp_path, monkeypatch, nr=40, L=300)
    for pkg, cfg in ((jnearest, {}), (pnearest, {"device": "cpu"})):
        pkg.run_nearest(["db.fa"], "q.fa", pkg.NearestConfig(
            nbest=4, pool=16, output=pkg.__name__.split(".")[0],
            codec=codec, **cfg))
    for ext in (".csv", ".aln"):
        with open_read("uvaia_tpu" + ext + suffix) as a, \
                open_read("uvaia_tpu_torch" + ext + suffix) as b:
            assert a.read() == b.read()


def test_store_record_window_matches_jax(tmp_path, monkeypatch):
    """skip_records / limit_records (the row window multi-host runs use
    to share one store) on an ingested store."""
    _files(tmp_path, monkeypatch, nr=90, L=300)
    ingest(["db.fa"], "db.uvst", block=32)
    _run_both(["db.uvst"], skip_records=20, limit_records=71)


@pytest.mark.parametrize("prune", [True, False])
def test_port_resumes_jax_checkpoint(tmp_path, monkeypatch, prune):
    """uvaia_tpu crashes after a checkpoint; the port resumes the same
    snapshot to the bytes uvaia_tpu's own resume writes."""
    _files(tmp_path, monkeypatch, nr=70, L=400, seed=77)
    _resume_jax_checkpoint(monkeypatch, prune)


@pytest.mark.parametrize("prune", [True, False])
def test_port_resumes_jax_acgt_checkpoint(tmp_path, monkeypatch, prune):
    """test_port_resumes_jax_checkpoint for an --acgt run."""
    _files(tmp_path, monkeypatch, nr=70, L=400, seed=79)
    _resume_jax_checkpoint(monkeypatch, prune, acgt=True)


def _resume_jax_checkpoint(monkeypatch, prune, acgt=False):
    target = "flush_survivors" if prune else "scan_step_delta"
    orig = getattr(jnearest.scan, target)
    count = {"n": 0}

    def crashing(*a, **kw):
        if count["n"] >= 2:
            raise _Boom("simulated crash")
        count["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(jnearest.scan, target, crashing)
    kw = dict(nbest=5, pool=16, prune=prune, checkpoint="c.ckpt",
              output="jres", acgt=acgt)
    with pytest.raises(_Boom):
        jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
            checkpoint_every=0.0, **kw))
    monkeypatch.setattr(jnearest.scan, target, orig)
    # the same snapshot and partial dump, once for each package
    shutil.copy("c.ckpt", "p.ckpt")
    shutil.copy("jres.aln.xz", "pres.aln.xz")
    jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
        checkpoint_every=1e9, **kw))
    kw.update(checkpoint="p.ckpt", output="pres")
    pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
        checkpoint_every=1e9, device="cpu", **kw))
    _same_outputs("jres", "pres")
    # and the resumed table is the uninterrupted one
    pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
        nbest=5, pool=16, prune=prune, output="full", device="cpu",
        acgt=acgt))
    assert filecmp.cmp("full.csv.xz", "pres.csv.xz", shallow=False)


def test_port_checkpoint_resumes_in_port(tmp_path, monkeypatch):
    """The port's own crash + resume, on the dense path."""
    _files(tmp_path, monkeypatch, nr=70, L=400, seed=78)
    count = {"n": 0}
    orig = pnearest.scan.scan_step_packed, pnearest.scan.scan_step_delta

    def crashing(step):
        def run(*a, **kw):
            if count["n"] >= 2:
                raise _Boom("simulated crash")
            count["n"] += 1
            return step(*a, **kw)
        return run

    monkeypatch.setattr(pnearest.scan, "scan_step_packed", crashing(orig[0]))
    monkeypatch.setattr(pnearest.scan, "scan_step_delta", crashing(orig[1]))
    kw = dict(nbest=5, pool=16, prune=False, device="cpu",
              checkpoint="c.ckpt", output="part")
    with pytest.raises(_Boom):
        pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
            checkpoint_every=0.0, **kw))
    monkeypatch.setattr(pnearest.scan, "scan_step_packed", orig[0])
    monkeypatch.setattr(pnearest.scan, "scan_step_delta", orig[1])
    pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
        checkpoint_every=1e9, **kw))
    pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
        nbest=5, pool=16, prune=False, device="cpu", output="full"))
    assert filecmp.cmp("full.csv.xz", "part.csv.xz", shallow=False)


@pytest.mark.parametrize("extra,n_cuda", [
    (["--devices", "4", "--site-shards", "3"], 0),
    (["--device", "cuda", "--devices", "2"], 1),
    (["--num-hosts", "2"], 0),
    (["--device", "cuda"], 0), (["--acgt", "--device", "cuda"], 0)])
def test_cli_refuses_unported_and_missing_gpu(tmp_path, monkeypatch,
                                              extra, n_cuda):
    """Refusals uvaia_tpu makes too: a --site-shards that does not divide
    --devices, a CUDA mesh larger than the visible cards (one card
    visible), --num-hosts > 1 without --coordinator; and --device cuda
    without a GPU."""
    _files(tmp_path, monkeypatch, nr=10, L=200)
    cuda = pnearest.torch.cuda
    monkeypatch.setattr(cuda, "is_available", lambda: n_cuda > 0)
    monkeypatch.setattr(cuda, "device_count", lambda: n_cuda)
    argv = ["nearest", "-r", "db.fa", "q.fa", "-o", "x"]
    if "--device" not in extra:
        argv += ["--device", "cpu"]
    with pytest.raises(SystemExit) as exc:
        port_main(argv + extra)
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "x.csv.xz").exists()


def test_cli_runs_on_cpu(tmp_path, monkeypatch):
    _files(tmp_path, monkeypatch, nr=30, L=300)
    assert port_main(["nearest", "-r", "db.fa", "q.fa", "-n", "4", "-p",
                      "8", "-o", "cli", "--device", "cpu"]) == 0
    jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
        nbest=4, pool=8, output="jax"))
    _same_outputs("cli", "jax")


def test_cli_runs_acgt_on_cpu(tmp_path, monkeypatch, capsys):
    """`nearest --acgt --device cpu` through the port's command line
    writes uvaia_tpu's bytes and header, and logs the --acgt mode line."""
    _files(tmp_path, monkeypatch, nr=30, L=300)
    assert port_main(["nearest", "-r", "db.fa", "q.fa", "-n", "4", "-p",
                      "8", "-o", "cli", "--acgt", "--device", "cpu"]) == 0
    assert "Considering ACGT differences only" in capsys.readouterr().err
    jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
        nbest=4, pool=8, output="jax", acgt=True))
    _same_outputs("cli", "jax")
    with lzma.open("cli.csv.xz", "rt") as fh:
        assert fh.readline() == pnearest.CSV_HEADER_ACGT
