"""The port's multi-process scan (uvaia_tpu_torch.parallel.multihost)
on the scenarios of tests/test_multihost.py: two port processes on the
CPU, meeting in a gloo group on a free localhost port, write a merged
CSV byte-equal to uvaia_tpu's single-process CSV.  The child processes
import only uvaia_tpu_torch; the JAX package runs in the test process."""

import filecmp
import lzma
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import uvaia_tpu.engine.nearest as jnearest
import uvaia_tpu.parallel.multihost as jmh
from uvaia_tpu.io.store import StoreStreamer as JStoreStreamer
from uvaia_tpu.io.store import ingest as jingest
from uvaia_tpu_torch.engine import nearest as pnearest
from uvaia_tpu_torch.io.store import StoreStreamer, ingest, peek_store_rows
from uvaia_tpu_torch.io.fasta import read_fasta_all
from uvaia_tpu_torch.parallel import multihost as mh

from test_nearest import random_seqs, write_fasta

REPO = str(Path(__file__).resolve().parent.parent)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_processes(tmp_path, refs, cfg_kw: str):
    """Run the port's run_nearest_multihost in two child processes;
    their outputs (each must exit 0)."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from uvaia_tpu_torch.engine.nearest import NearestConfig
        from uvaia_tpu_torch.parallel.multihost import run_nearest_multihost
        pid = int(sys.argv[1])
        cfg = NearestConfig(device="cpu", {cfg_kw})
        run_nearest_multihost({refs!r}, "q.fa", cfg, 2, pid,
                              coordinator="localhost:{_free_port()}")
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pid)],
                              cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-2000:]
    return outs


def _db_files(rng, L, sizes):
    files, base = [], 0
    for f, nr in enumerate(sizes):
        write_fasta(f"db{f}.fa", [f"r{base + i}" for i in range(nr)],
                    random_seqs(rng, nr, L))
        files.append(f"db{f}.fa")
        base += nr
    return files


def test_assign_files_contiguous(tmp_path):
    """The port's file split equals the JAX package's, contiguous and
    complete, for several process counts."""
    paths = []
    for i, size in enumerate([100, 5, 5, 100, 40, 0, 7]):
        p = tmp_path / f"f{i}"
        p.write_bytes(b"x" * size)
        paths.append(str(p))
    for n in (1, 2, 3, 5, 9):
        parts = [mh.assign_files(paths, n, pid) for pid in range(n)]
        assert parts == [jmh.assign_files(paths, n, pid) for pid in range(n)]
        assert sum(parts, []) == paths
    assert all(mh.assign_files(paths[:5], 3, pid) for pid in range(3))


def test_two_process_merge_equals_single(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(55)
    L, nq, k = 300, 4, 6
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    db_files = _db_files(rng, L, [40, 25, 35])
    jnearest.run_nearest(db_files, "q.fa", jnearest.NearestConfig(
        nbest=k, pool=16, output="single"))
    outs = _two_processes(tmp_path, db_files,
                          f"nbest={k}, pool=16, output='mh'")
    assert filecmp.cmp("mh.csv.xz", "single.csv.xz", shallow=False)
    assert b"scanning 1 of 3 database files" in outs[1]
    # the per-host dumps jointly cover every reference named in the CSV
    dumped = {r.name for h in range(2)
              for r in read_fasta_all(f"mh.h{h}.aln.xz")}
    merged = lzma.open("mh.csv.xz", "rb").read().decode()
    assert {ln.split(",")[1] for ln in merged.strip().split("\n")[1:]} \
        <= dumped


def test_two_process_store_row_split_equals_single(tmp_path, monkeypatch):
    """One store, ingested by the port, shared by two processes through
    contiguous row windows, merges to uvaia_tpu's single-process CSV of
    the source FASTA."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(91)
    L, nq, nr, k = 300, 4, 90, 6
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    write_fasta("db.fa", [f"r{i}" for i in range(nr)],
                random_seqs(rng, nr, L))
    ingest(["db.fa"], "db.uvst", block=16)
    assert peek_store_rows("db.uvst") == nr
    jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
        nbest=k, pool=16, output="single"))
    outs = _two_processes(tmp_path, ["db.uvst"],
                          f"nbest={k}, pool=16, output='mhs'")
    for o in outs:
        assert b"scanning store rows" in o
    assert filecmp.cmp("mhs.csv.xz", "single.csv.xz", shallow=False)


def test_store_row_window(tmp_path, monkeypatch):
    """The port's StoreStreamer [skip, limit) windows tile a store
    exactly (boundaries inside a store block), on a store of each
    package, with the JAX package's windows' names."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(92)
    L, nr = 200, 53
    write_fasta("db.fa", [f"r{i}" for i in range(nr)],
                random_seqs(rng, nr, L))
    ingest(["db.fa"], "port.uvst", block=16)
    jingest(["db.fa"], "jax.uvst", block=16)

    def names_of(cls, path, skip, limit):
        ss = cls([path], L, 8, ref_ambiguity=1.0, skip_records=skip,
                 limit_records=limit)
        return [nm for b, _ in ss for nm in b.names]

    cuts = [0, 19, 37, nr]          # 19 and 37 fall mid-block
    for path in ("port.uvst", "jax.uvst"):
        full = names_of(StoreStreamer, path, 0, 0)
        assert full == [f"r{i}" for i in range(nr)]
        tiled = [names_of(StoreStreamer, path, cuts[i], cuts[i + 1])
                 for i in range(3)]
        assert sum(tiled, []) == full
        assert tiled == [names_of(JStoreStreamer, path, cuts[i],
                                  cuts[i + 1]) for i in range(3)]


def test_merge_and_write_single_host_roundtrip(tmp_path, monkeypatch):
    """The port's merge_and_write over one host's state reproduces its
    write_csv and uvaia_tpu's CSV; a name longer than NAME_W widens the
    slot instead of truncating."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(66)
    L, nq, nr, k = 250, 3, 30, 4
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    write_fasta("db.fa", [f"r{i}" + ("x" * 300 if i == 7 else "")
                          for i in range(nr)], random_seqs(rng, nr, L))
    res = pnearest.run_nearest(["db.fa"], "q.fa", pnearest.NearestConfig(
        nbest=k, pool=16, output="direct", device="cpu"))
    jnearest.run_nearest(["db.fa"], "q.fa", jnearest.NearestConfig(
        nbest=k, pool=16, output="jax"))
    mh.run_nearest_multihost(["db.fa"], "q.fa", pnearest.NearestConfig(
        nbest=k, pool=16, output="one", device="cpu"), 1, 0)
    name_w = max(mh.NAME_W, *(len(n) for n in res.names.values()))
    names = np.zeros((nq, k, name_w), dtype=np.uint8)
    for qi in range(nq):
        for slot in range(k):
            ri = int(res.indices[qi, slot])
            if ri == 2**31 - 1:
                continue
            b = res.names[ri].encode()
            names[qi, slot, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    mh.merge_and_write(res.pack, res.scores.astype(np.int32)[None],
                       res.indices.astype(np.int32)[None], names[None],
                       "merged.csv.xz")
    for other in ("direct.csv.xz", "jax.csv.xz", "one.csv.xz"):
        assert filecmp.cmp("merged.csv.xz", other, shallow=False), other


def test_two_process_crash_resume_equals_single(tmp_path, monkeypatch):
    """Host 1 of a two-process run crashes mid-scan after a checkpoint
    (the crash injected into the port's scan.flush_survivors); the rerun
    resumes that host from its per-host checkpoint and the merged CSV
    still equals uvaia_tpu's single-process scan."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(77)
    L, nq, k = 300, 4, 6
    write_fasta("q.fa", [f"q{i}" for i in range(nq)],
                random_seqs(rng, nq, L))
    db_files = _db_files(rng, L, [40, 25, 60])
    jnearest.run_nearest(db_files, "q.fa", jnearest.NearestConfig(
        nbest=k, pool=16, output="single"))

    class _Boom(RuntimeError):
        pass

    count = {"n": 0}
    orig = pnearest.scan.flush_survivors

    def crashing(*a, **kw):
        if count["n"] >= 1:
            raise _Boom("simulated host crash")
        count["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(pnearest.scan, "flush_survivors", crashing)
    with pytest.raises(_Boom):
        pnearest.run_nearest(mh.assign_files(db_files, 2, 1), "q.fa",
                             pnearest.NearestConfig(
                                 nbest=k, pool=16, output="mh.h1",
                                 checkpoint="scan.ckpt.h1",
                                 checkpoint_every=0.0, device="cpu"))
    monkeypatch.setattr(pnearest.scan, "flush_survivors", orig)
    assert Path("scan.ckpt.h1").exists()
    outs = _two_processes(
        tmp_path, db_files, f"nbest={k}, pool=16, output='mh', "
        "checkpoint='scan.ckpt', checkpoint_every=1e9")
    assert b"Resuming from checkpoint" in outs[1], outs[1].decode()[-2000:]
    assert filecmp.cmp("mh.csv.xz", "single.csv.xz", shallow=False)
