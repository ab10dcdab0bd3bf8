"""The port's tracer (uvaia_tpu_torch/utils/observe.py) on the CPU: spans,
their parents and job across threads, the ring, the switch, the
profiler's ranges, and the spans and counters of tiny `nearest` and
`align` jobs held against the jobs' own log lines and outputs."""

import lzma
import os
import re
import threading

import numpy as np
import pytest
import torch

from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.io.store import ingest
from uvaia_tpu_torch.ops import host, scan
from uvaia_tpu_torch.utils import observe

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _dna(rng, n: int) -> bytes:
    return ACGT[rng.integers(0, 4, n)].tobytes()


def _write(path, recs):
    with open(path, "w") as fh:
        for name, seq in recs:
            fh.write(f">{name}\n{seq.decode()}\n")


def _mutate(rng, seq: bytes, rate: float) -> bytes:
    a = np.frombuffer(seq, np.uint8).copy()
    hit = rng.random(a.size) < rate
    a[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
    return a.tobytes()


def _children_cover(job) -> float:
    """Share of the root's time inside its children on its thread."""
    root = job.root
    inside = sum(s.t1 - s.t0 for s in job.spans
                 if s.parent == root.id and s.thread == root.thread)
    return inside / (root.t1 - root.t0)


# ----------------------------------------------------------------------
# the tracer


def test_spans_nest_and_share_the_job_across_threads():
    tr = observe.Tracer()
    lines = []
    with tr.span("outside"):
        pass

    def worker():
        with tr.span("other"):
            with tr.span("other_inner"):
                tr.count("rows", 3)

    with tr.job("tool", lines.append) as root:
        with tr.span("a"):
            with tr.span("b") as b:
                pass
            tr.count("rows", 2)
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        list(tr.iter_spans("each", range(3)))
    assert b.seconds() > 0 and root.seconds() >= b.seconds()
    (job,) = tr.jobs()
    by = {}
    for s in job.spans:
        by.setdefault(s.name, []).append(s)
    assert "outside" not in by
    (a,), (b,) = by["a"], by["b"]
    (o,), (oi,) = by["other"], by["other_inner"]
    assert job.root.parent is None and a.parent == job.root.id
    assert b.parent == a.id and oi.parent == o.id
    assert o.parent == job.root.id and o.thread != job.root.thread
    assert len(by["each"]) == 4          # three items and the end
    assert {s.job for s in job.spans} == {job.id}
    assert job.counts == {"rows": 5}
    assert a.t0 <= b.t0 <= b.t1 <= a.t1
    assert lines == [job.line()]
    assert lines[0].startswith("Trace: tool ") and "a=" in lines[0] \
        and lines[0].endswith("; rows=5")


def test_a_job_inside_a_job_is_a_span():
    tr = observe.Tracer()
    with tr.job("outer"):
        with tr.job("inner"):
            with tr.span("x"):
                pass
    (job,) = tr.jobs()
    inner = next(s for s in job.spans if s.name == "inner")
    assert next(s for s in job.spans if s.name == "x").parent == inner.id


@pytest.mark.parametrize("trace", ["1", "0"])
def test_a_job_counts_whether_or_not_it_records(monkeypatch, trace):
    monkeypatch.setenv("UVAIA_TPU_TRACE", trace)
    tr = observe.Tracer()
    with tr.job("tool") as root:
        with tr.span("dev", device=torch.device("cpu")):
            tr.count("rows", 4)
        tr.count("rows", 1)
        assert root.counts == {"rows": 5}
    if trace == "0":
        assert tr.jobs() == []
    else:
        (job,) = tr.jobs()
        (dev,) = job.spans
        assert dev.device_ns is None and job.counts is root.counts


def test_the_ring_keeps_the_last_jobs():
    assert observe.TRACER.ring.maxlen == observe.RING == 256
    tr = observe.Tracer(ring=4)
    for i in range(6):
        with tr.job(f"t{i}"):
            pass
    assert [j.tool for j in tr.jobs()] == ["t2", "t3", "t4", "t5"]


def test_self_time_leaves_out_children_on_the_same_thread():
    root = observe.SpanRecord("r", 1, None, 9, 7, 0, 100)
    job = observe.JobRecord(9, "r", root, spans=[
        observe.SpanRecord("a", 2, 1, 9, 7, 10, 60),
        observe.SpanRecord("b", 3, 2, 9, 7, 20, 30),
        observe.SpanRecord("b", 4, 2, 9, 7, 40, 45),
        observe.SpanRecord("t", 5, 1, 9, 8, 0, 90),   # another thread
        observe.SpanRecord("u", 6, 5, 9, 8, 5, 15)])
    assert job.self_ns() == {"t": 80, "u": 10, "a": 35, "b": 15}


def test_profiler_shows_the_spans_as_ranges():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with observe.job("probe_job"):
            with observe.span("probe_range"):
                torch.ones(64).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"probe_job", "probe_range"} <= names


# ----------------------------------------------------------------------
# the engines' jobs


def _nearest_files(store: bool) -> str:
    rng = np.random.default_rng(31)
    L = 400
    base = _dna(rng, L)
    founders = [_mutate(rng, base, 0.03) for _ in range(4)]
    db = [_mutate(rng, founders[i % 4], 0.01) for i in range(120)]
    db[5] = b"N" * L                        # too ambiguous: invalid
    qs = [_mutate(rng, founders[i % 4], 0.01) for i in range(5)]
    _write("q.fa", [(f"q{i}", s) for i, s in enumerate(qs)])
    _write("db.fa", [(f"r{i}", s) for i, s in enumerate(db)])
    if not store:
        return "db.fa"
    ingest(["db.fa"], "db.uvst")
    return "db.uvst"


def _nearest(db: str, prune: bool, *extra) -> int:
    return port_main(["nearest", "-r", db, "q.fa", "-n", "4", "-p", "16",
                      "-o", "out", "--device", "cpu", *extra]
                     + ([] if prune else ["--no-prune"]))


NEAREST_SPANS = {"query_pack", "device_data", "stream_wait", "stream_read",
                 "upload_prune", "device_wait", "dump_write", "dump_close",
                 "csv"}


@pytest.mark.parametrize("layout", [(), ("--devices", "2")],
                         ids=["single", "sharded"])
@pytest.mark.parametrize("store", [False, True], ids=["fasta", "store"])
@pytest.mark.parametrize("prune", [True, False], ids=["prune", "no_prune"])
def test_nearest_job_counts_agree_with_its_outputs(tmp_path, monkeypatch,
                                                   capsys, store, prune,
                                                   layout):
    """Every mode of the scan (prune or dense, on one device or sharded
    over two) records the same spans and counters, and they agree with
    its outputs."""
    monkeypatch.chdir(tmp_path)
    db = _nearest_files(store)
    capsys.readouterr()
    assert _nearest(db, prune, *layout) == 0
    err = capsys.readouterr().err
    job = observe.jobs()[-1]
    c = job.counts
    assert job.tool == "nearest"
    assert re.search(r"^Trace: nearest ", err, re.M)
    assert err.rstrip().splitlines()[-1] == job.line()
    assert ("Sharded scan over mesh (db=2" in err) == bool(layout)
    read, saved = map(int, re.search(
        r"Total of (\d+) sequences read; (\d+) saved", err).groups())
    assert c["rows_read"] == read == 120 and c["rows_invalid"] == 1
    assert c["rows_same_name"] == 0
    assert c["dump_records"] == saved > 0
    skip = re.search(r"skipped the exact scan for (\d+) of (\d+)", err)
    if prune:
        x, y = map(int, skip.groups())
        assert c["rows_scored"] == y - x and y == 119
    else:
        assert skip is None and c["rows_scored"] == 119
    with lzma.open("out.csv.xz", "rt") as fh:
        assert c["csv_rows"] == len(fh.readlines()) - 1 == 5 * 4
    assert c["csv_bytes"] == os.path.getsize("out.csv.xz")
    assert c["dump_bytes"] == os.path.getsize("out.aln.xz")
    assert c["batches"] == 8 and c["h2d_bytes"] > 0
    assert c.get("flushes", 0) >= (1 if prune else 0)
    names = {s.name for s in job.spans}
    want = NEAREST_SPANS | ({"retain", "flush"} if prune else set())
    assert want <= names, want - names
    assert _children_cover(job) >= 0.95


@pytest.mark.parametrize("case", ["fasta", "store", "store_no_native"])
def test_nearest_bulk_decode_counts_the_retained_store_rows(
        tmp_path, monkeypatch, case):
    """A prune job on a store decodes every row it retains in the native
    bulk call (`bulk_decode_rows` = `rows_scored`); on FASTA, and on a
    store without the native library, it decodes none there."""
    from uvaia_tpu_torch.io import native
    monkeypatch.chdir(tmp_path)
    if case.endswith("no_native"):
        monkeypatch.setenv("UVAIA_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_failed", False)
    db = _nearest_files(case != "fasta")
    assert _nearest(db, True) == 0
    c = observe.jobs()[-1].counts
    assert c["rows_scored"] > 0
    assert c.get("bulk_decode_rows", 0) == (
        c["rows_scored"] if case == "store" else 0)


UPLOAD_COUNTS = ("delta_batches", "packed_batches", "delta_rows",
                 "delta_slots")


@pytest.mark.parametrize("case", ["fasta", "store", "fasta_trace_off"])
def test_nearest_stream_spans_and_upload_counters(tmp_path, monkeypatch,
                                                  capsys, case):
    """The FASTA stream's reader thread records `stream_read` and the
    encode pool `delta_encode`; the upload counters add up to the
    batches and to the (pos, val) shapes the scan was given, on both
    streams; with the trace off no job is recorded."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("UVAIA_TPU_ENCODE_THREADS", "2")
    if case.endswith("trace_off"):
        monkeypatch.setenv("UVAIA_TPU_TRACE", "0")
    db = _nearest_files(case == "store")
    encode = host.delta_encode
    calls = {"n": 0}

    def every_third_packed(*a, **kw):
        # the 4-bit packed fallback for every third batch
        calls["n"] += 1
        return None if calls["n"] % 3 == 0 else encode(*a, **kw)
    monkeypatch.setattr(host, "delta_encode", every_third_packed)
    shapes, packed = [], []
    prune_delta, prune_packed = scan.prune_and_hold_delta, \
        scan.prune_and_hold

    def spy_delta(qd, state, pos, val, ok):
        shapes.append(tuple(pos.shape))
        return prune_delta(qd, state, pos, val, ok)

    def spy_packed(qd, state, codes, ok):
        packed.append(codes.shape[0])
        return prune_packed(qd, state, codes, ok)
    monkeypatch.setattr(scan, "prune_and_hold_delta", spy_delta)
    monkeypatch.setattr(scan, "prune_and_hold", spy_packed)
    before = observe.jobs()[-1:]
    capsys.readouterr()
    assert _nearest(db, True) == 0
    err = capsys.readouterr().err
    if case.endswith("trace_off"):
        assert observe.jobs()[-1:] == before and "Trace:" not in err
        assert shapes and packed
        return
    job = observe.jobs()[-1]
    c = job.counts
    n_packed = c.get("packed_batches", 0)
    assert c["delta_batches"] == len(shapes) and n_packed == len(packed)
    assert c["delta_batches"] + n_packed == c["batches"] == 8
    assert c["delta_rows"] == sum(b for b, _ in shapes)
    assert c["delta_slots"] == sum(b * e for b, e in shapes)
    line = err.rstrip().splitlines()[-1]
    threads: dict[str, set] = {}
    for s in job.spans:
        threads.setdefault(s.name, set()).add(s.thread)
    assert len(threads["stream_read"]) == 1
    assert job.root.thread not in threads["stream_read"]
    if case == "store":
        assert packed == [] and "delta_encode" not in threads
        assert "encode_workers" not in c and "stream_bytes" not in c
    else:
        assert packed and calls["n"] == 8
        assert c["encode_workers"] == 2
        assert c["stream_bytes"] == (c["rows_read"] - c["rows_invalid"]) \
            * 400
        assert 1 <= len(threads["delta_encode"]) <= 2
        assert not threads["delta_encode"] & (threads["stream_read"]
                                              | {job.root.thread})
        assert sum(s.name == "delta_encode" for s in job.spans) == 8
        assert "delta_encode=" in line and "encode_workers=2" in line
    for name in UPLOAD_COUNTS:
        if name in c:
            assert f"{name}={c[name]}" in line


def _align_files(escalate: bool):
    rng = np.random.default_rng(12)
    n = 600
    ref = _dna(rng, n)
    qs = [_mutate(rng, ref, 0.01) for _ in range(5)]
    qs.append(ref[:100])                    # wrong length: rejected
    if escalate:
        # a 100-base insertion and a 100-base deletion 100 sites apart:
        # the length matches, so the row is routed to the narrowest
        # band, which its optimum leaves
        qs.append(ref[:200] + _dna(rng, 100) + ref[200:300] + ref[400:])
    _write("ref.fa", [("ref", ref)])
    _write("q.fa", [(f"a{i}", s) for i, s in enumerate(qs)])
    return len(qs) - 1


ALIGN_SPANS = {"reference", "read_wait", "read_qc", "dispatch", "upload",
               "forward", "walks", "collect", "device_wait", "decode",
               "write", "writer_close"}


@pytest.mark.parametrize("escalate", [False, True],
                         ids=["routed", "escalated"])
def test_align_job_counts_agree_with_its_outputs(tmp_path, monkeypatch,
                                                 capsys, escalate):
    monkeypatch.chdir(tmp_path)
    passing = _align_files(escalate)
    assert port_main(["align", "-r", "ref.fa", "q.fa", "-o", "out",
                      "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    job = observe.jobs()[-1]
    c = job.counts
    assert job.tool == "align"
    assert err.rstrip().splitlines()[-1] == job.line()
    read, aligned, failed = map(int, re.search(
        r"Total: (\d+) read, (\d+) aligned, .* (\d+) failed\.", err).groups())
    assert c["rows_read"] == read and c["rows_rejected"] == 1
    assert c["forward_rows"] == passing == aligned
    assert c["failed_rows"] == failed == 0
    assert c["forward_cells"] >= passing * 600 * 129
    if escalate:
        assert c["redo_rows"] > 0
        assert "escalate" in {s.name for s in job.spans}
    else:
        assert c.get("redo_rows", 0) == 0
    names = {s.name for s in job.spans}
    assert ALIGN_SPANS <= names, ALIGN_SPANS - names
    assert _children_cover(job) >= 0.95


@pytest.mark.parametrize("tool", ["nearest", "align"])
def test_trace_off_records_nothing_and_keeps_the_log(tmp_path, monkeypatch,
                                                     capsys, tool):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("UVAIA_TPU_TRACE", "0")
    before = observe.jobs()[-1:]
    if tool == "nearest":
        _nearest(_nearest_files(False), True)
        want = [r"Prepared 5 query sequences in \d+\.\d\ds;",
                r"skipped the exact scan for \d+ of 119 references",
                r"Total of 120 sequences read; [1-9]\d* saved .*, 1 too "
                r"ambiguous \(excluded\)\. \d+\.\d\ds scan time\.",
                r"; \d+\.\d\ds total\."]
    else:
        _align_files(False)
        port_main(["align", "-r", "ref.fa", "q.fa", "-o", "out",
                   "--device", "cpu"])
        want = [r"Total: 6 read, 5 aligned, 1 wrong length, .* 0 "
                r"uncertified \(band cap\), 0 failed\. \d+\.\d{3} secs "
                r"total\."]
    err = capsys.readouterr().err
    assert observe.jobs()[-1:] == before
    assert "Trace:" not in err
    for pat in want:
        assert re.search(pat, err), pat
