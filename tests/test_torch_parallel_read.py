"""The ranged reader of raw FASTA files (engine/stream.RefStreamer,
csrc/host/fasta_io.cpp ``ufa_map_*``), on its pool of range parsers and
on the reader thread alone, against the serial native reader on the same
text (a gzip copy of each file, which only the serial reader reads):
every RefBatch (codes, raw bytes, names, ok, n, base_idx, records_read,
n_invalid, same_name) and the StreamStats must be equal, and a file the
serial reader refuses is refused with the same message after the same
batches.  ``RANGE_ROWS`` is lowered so that the pool takes these small
files; ``read_workers`` is replaced to set the pool's size.  The row
buffers go back to their stream only when no view of a batch is left.
End to end, with the pool on: `nearest` and a checkpoint resume
byte-equal to the JAX package, and an `ingest` whose store equals the
serial reader's file for file."""

import gzip
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

import uvaia_tpu.io.store as jstore
from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.engine import stream
from uvaia_tpu_torch.io import native
from uvaia_tpu_torch.io import store as pstore
from uvaia_tpu_torch.utils import observe

from test_torch_nearest import _files, _resume_jax_checkpoint, _run_both
from test_torch_store import _same_dirs

L = 97
BATCH = 8
ALPHABET = np.frombuffer(b"ACGTRYSWKMBDHVNU-?.*acgtnrykX\xc3", np.uint8)
FORMS = ["single", "wrapped", "crlf", "lower", "blanks", "gt_in_header",
         "no_final_newline", "mixed"]


@pytest.fixture(autouse=True)
def _native_lib():
    if native.get_lib() is None:
        pytest.skip("g++ cannot build the native library here")


def _genomes(seed: int, n: int, n_sites: int = L):
    """(names, sequences): random IUPAC rows, every fifth mostly N (a QC
    reject at ref_ambiguity 0.5)."""
    rng = np.random.default_rng(seed)
    names, seqs = [], []
    for i in range(n):
        row = ALPHABET[rng.integers(0, len(ALPHABET), n_sites)].copy()
        if i % 5 == 3:
            row[rng.random(n_sites) < 0.8] = ord("N")
        names.append(f"r{i} sample|{i % 7}")
        seqs.append(row.tobytes())
    return names, seqs


def _layout(rng, name: str, seq: bytes, form: str) -> bytes:
    """One record in the given form."""
    if form == "mixed":
        form = FORMS[int(rng.integers(0, 5))]
    nl = b"\r\n" if form == "crlf" else b"\n"
    if form == "gt_in_header":
        name = name.replace(" ", " >x> ")
    if form == "lower":
        seq = seq.lower()
    if form in ("wrapped", "crlf", "blanks"):
        lines = [seq[j:j + 23] for j in range(0, len(seq), 23)]
    else:
        lines = [seq]
    if form == "blanks":
        lines = [ln[:3] + b" \t" + ln[3:] for ln in lines]
        lines.insert(2, b"")
        lines.append(b"")
    return b">" + name.encode() + nl + nl.join(lines) + nl


def _text(names, seqs, form: str, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    out = b"".join(_layout(rng, nm, sq, form) for nm, sq in zip(names, seqs))
    if form == "no_final_newline":
        out = out.rstrip(b"\n")
    return out


INLINE = 10 ** 9      # a range size no file here reaches: no pool


def _gz_copies(paths):
    """A gzip copy of each raw file (read by the serial reader), the
    others as they are."""
    out = []
    for p in map(str, paths):
        if not p.endswith(".gz"):
            with open(p, "rb") as src, gzip.open(p + ".gz", "wb") as dst:
                shutil.copyfileobj(src, dst)
            p += ".gz"
        out.append(p)
    return out


def _pooled(monkeypatch, workers: int, range_rows: int):
    monkeypatch.setattr(stream, "RANGE_ROWS", range_rows)
    monkeypatch.setattr(stream, "read_workers", lambda: workers)


def _read(paths, n_sites=L, batch=BATCH, **kw):
    """(batches, stats, job counters, SystemExit message or None)."""
    got, err = [], None
    with observe.job("read") as job:
        st = stream.RefStreamer([str(p) for p in paths], n_sites, batch,
                                **kw)
        try:
            for b in st:
                got.append(b)
        except SystemExit as e:
            err = str(e)
    return got, st.stats, dict(job.counts), err


def _same(a, b):
    """Two _read results are equal, batch for batch."""
    (ga, sa, _, ea), (gb, sb, _, eb) = a, b
    assert ea == eb
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert x.names == y.names
        for f in ("n", "base_idx", "records_read", "n_invalid",
                  "same_name"):
            assert getattr(x, f) == getattr(y, f), f
        for f in ("codes", "ok", "raw"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f),
                                          err_msg=f)
    assert (sa.count, sa.n_invalid, sa.same_name) == \
        (sb.count, sb.n_invalid, sb.same_name)
    assert [f.removesuffix(".gz") for f in sa.files] == \
        [f.removesuffix(".gz") for f in sb.files]


def _both(monkeypatch, paths, workers=3, range_rows=3, **kw):
    """The serial read of the files' gzip copies and the ranged read of
    the files; equal."""
    _pooled(monkeypatch, workers, range_rows)
    want = _read(_gz_copies(paths), **kw)
    got = _read(paths, **kw)
    _same(want, got)
    return want, got


# ----------------------------------------------------------------------
# batches


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("workers,range_rows", [
    (1, 3), (2, 4), (3, 5), (8, 1), (2, BATCH), (4, INLINE)],
    ids=["w1-r3", "w2-r4", "w3-r5", "w8-r1", "w2-r8", "inline"])
def test_pool_batches_equal_serial(tmp_path, monkeypatch, form, workers,
                                   range_rows):
    """43 records (no range size divides it), QC rejects every fifth,
    and names excluded on either side of range and batch boundaries;
    `inline`: the file holds less than two ranges, so the reader thread
    parses it alone."""
    names, seqs = _genomes(1, 43)
    path = tmp_path / "db.fa"
    path.write_bytes(_text(names, seqs, form))
    if form == "gt_in_header":
        names = [nm.replace(" ", " >x> ") for nm in names]
    excl = {names[i] for i in (2, 3, 7, 8, 15, 16, 24, 42)}
    want, got = _both(monkeypatch, [path], workers, range_rows,
                      exclude_names=excl)
    batches, stats, counts, err = got
    assert err is None and stats.count == 43
    assert stats.same_name == 8 and stats.n_invalid > 0
    pooled = range_rows != INLINE
    assert counts["read_workers"] == (workers if pooled else 0)
    assert counts["range_rows"] == (43 if pooled else 0)
    assert counts["row_buffers"] > 0
    assert want[2]["read_workers"] == want[2]["range_rows"] == 0
    assert "row_buffers" not in want[2]


def test_pool_reuses_rows_nothing_refers_to(tmp_path, monkeypatch):
    """Batches compared as they come and then dropped, so that later
    batches take the rows of earlier ones: still the serial reader's.
    The next stream maps its own buffers."""
    names, seqs = _genomes(7, 150)
    path = tmp_path / "db.fa"
    path.write_bytes(_text(names, seqs, "mixed"))
    _pooled(monkeypatch, 3, 3)
    want = stream.RefStreamer(_gz_copies([path]), L, BATCH)
    for _ in range(2):
        with observe.job("read") as job:
            got = stream.RefStreamer([str(path)], L, BATCH)
            n = 0
            for a, b in zip(want, got, strict=True):
                _same(([a], want.stats, None, None),
                      ([b], want.stats, None, None))
                del a, b
                n += 1
        assert n == 15 and 0 < job.counts["row_buffers"] < n
        want = stream.RefStreamer(_gz_copies([path]), L, BATCH)


def test_row_buffers_come_back_when_no_view_is_left():
    rows = stream._RowBuffers(4, 10)
    a, b = rows.take(True), rows.take(False)
    first = a[0].ctypes.data
    assert b[0].ctypes.data != first
    assert a[1].ctypes.data == first + 40 and a[0].shape == (4, 10)
    del a
    c = rows.take(True)
    assert c[0].ctypes.data == first
    view = c[1][:2]
    del c
    assert rows.take(True)[0].ctypes.data != first
    del view
    assert rows.take(True)[0].ctypes.data == first
    other = stream._RowBuffers(4, 10)
    assert other.take(False)[0].ctypes.data not in (
        first, b[0].ctypes.data)        # a stream takes only its own


def test_row_buffers_never_hand_one_buffer_to_two_holders():
    """More threads than cores take rows of one stream's buffers, stamp
    them, let others run and check the stamp before dropping them: a
    buffer handed out while still held would carry another thread's
    stamp.  No more buffers are mapped than were ever held at once."""
    rows = stream._RowBuffers(2, 8)
    clashes, done = [], []
    n = 2 * (os.cpu_count() or 1) + 2

    def work(tid):
        for _ in range(300):
            raw, codes = rows.take(True)
            raw[:] = tid
            codes[:] = tid
            time.sleep(0)
            if (raw != tid).any() or (codes != tid).any():
                clashes.append(tid)
            del raw, codes
        done.append(tid)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    with observe.job("take") as job:
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == len(threads) and not clashes
    assert len(rows.free) == job.counts["row_buffers"] <= n


@pytest.mark.parametrize("skip", [2, 3, 7, 8, 11, 16, 40, 43, 50])
def test_pool_resume_skip_equals_serial(tmp_path, monkeypatch, skip):
    """skip_records before, at and across range (3) and batch (8)
    boundaries, and past the end."""
    names, seqs = _genomes(2, 43)
    path = tmp_path / "db.fa"
    path.write_bytes(_text(names, seqs, "mixed"))
    _both(monkeypatch, [path], skip_records=skip, initial_base=5)


@pytest.mark.parametrize("case", [
    "short_first", "short_in_second_batch", "long", "long_extra_line",
    "short_with_blank", "short_on_two_lines", "jump_trap",
    "jump_trap_late", "only_header_at_end", "bare_gt_at_end"])
@pytest.mark.parametrize("range_rows", [3, INLINE], ids=["pool", "inline"])
def test_pool_refuses_what_serial_refuses(tmp_path, monkeypatch, case,
                                          range_rows):
    """A record of another length: the same message, after the same
    batches.  A record's line of L bytes that holds a blank or a '\\n'
    is a short record; one followed by more lines is a long one.
    `jump_trap*`: a short record whose bytes put a '\\n>' where an
    aligned record would end, so a finder that jumped L + 1 bytes over
    each record would take two records for one."""
    names, seqs = _genomes(3, 30)
    text = _text(names, seqs, "single")
    if case == "short_first":
        text = b">short\nACGT\n" + text
    elif case == "short_in_second_batch":
        seqs[11] = seqs[11][:-1]
        text = _text(names, seqs, "single")
    elif case == "long":
        seqs[20] = seqs[20] + b"A"
        text = _text(names, seqs, "wrapped")
    elif case == "long_extra_line":
        seqs[20] = seqs[20] + b"\nAC"
        text = _text(names, seqs, "single")
    elif case in ("short_with_blank", "short_on_two_lines"):
        seqs[9] = seqs[9][:40] + (b" " if case == "short_with_blank"
                                  else b"\n") + seqs[9][41:]
        text = _text(names, seqs, "single")
    elif case.startswith("jump_trap"):
        # from the short record's sequence on: "ACG\n>b\n" + (L - 7)
        # bases is L bytes, then "\n>": one aligned record's span
        trap = b">a\nACG\n>b\n" + b"C" * (L - 7) + b"\n"
        at = 0 if case == "jump_trap" else text.index(b">r17 ")
        text = text[:at] + trap + text[at:]
    elif case == "only_header_at_end":
        text = text + b">last one"
    else:
        text = text + b">"
    path = tmp_path / "db.fa"
    path.write_bytes(text)
    (_, _, _, err), (batches, _, counts, _) = _both(
        monkeypatch, [path], range_rows=range_rows)
    if case == "bare_gt_at_end":
        assert err is None
        assert counts["range_rows"] == (30 if range_rows == 3 else 0)
    else:
        assert err is not None and "all sequences must be aligned" in err
    if case == "jump_trap_late":
        assert len(batches) == 1       # 13 of records 0-15 pass the QC


def test_pool_takes_several_files_and_an_empty_one(tmp_path, monkeypatch):
    """One stream over a pooled file, an empty file, a gzip file (the
    serial reader) and another pooled file, in that order."""
    names, seqs = _genomes(4, 40)
    a, empty, gz, b = (tmp_path / f for f in ("a.fa", "e.fa", "c.fa.gz",
                                               "b.fa"))
    a.write_bytes(_text(names[:13], seqs[:13], "wrapped"))
    empty.write_bytes(b"")
    gz.write_bytes(gzip.compress(_text(names[13:25], seqs[13:25], "crlf")))
    b.write_bytes(_text(names[25:], seqs[25:], "single", seed=1))
    _, (batches, stats, counts, _) = _both(monkeypatch, [a, empty, gz, b],
                                           workers=2, range_rows=2)
    assert stats.count == 40 and len(stats.files) == 4
    assert counts["read_workers"] == 2
    assert counts["range_rows"] == 13 + 15


@pytest.mark.parametrize("kind", ["gzip", "below_threshold", "no_native"])
def test_serial_inputs_take_no_pool(tmp_path, monkeypatch, kind):
    """A gzip file, a raw file below two ranges and any file without the
    library keep the serial reader: both counters 0."""
    names, seqs = _genomes(5, 12)
    text = _text(names, seqs, "single")
    path = tmp_path / ("db.fa.gz" if kind == "gzip" else "db.fa")
    path.write_bytes(gzip.compress(text) if kind == "gzip" else text)
    _pooled(monkeypatch, 4, 10 if kind == "below_threshold" else 2)
    if kind == "no_native":
        monkeypatch.setenv("UVAIA_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_failed", False)
    batches, stats, counts, err = _read([path])
    assert err is None and stats.count == 12 and len(batches) == 2
    assert counts["read_workers"] == counts["range_rows"] == 0


def test_read_workers_leave_the_other_threads_their_cores(monkeypatch):
    for cores, want in ((1, 1), (4, 1), (5, 1), (6, 2), (8, 4), (64, 4)):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda pid, n=cores: set(range(n)))
        assert stream.read_workers() == want, cores


# ----------------------------------------------------------------------
# end to end, with the pool on


@pytest.mark.parametrize("prune", [True, False])
def test_pooled_nearest_matches_jax(tmp_path, monkeypatch, prune):
    """test_torch_nearest's FASTA case (120 records, batches of 16) with
    ranges of 7 records on 3 workers: CSV and dump bytes equal."""
    _files(tmp_path, monkeypatch)
    _pooled(monkeypatch, 3, 7)
    res = _run_both(["db.fa"], prune=prune, trim=17)
    assert res.n_saved > 0
    job = observe.jobs()[-1]
    assert job.counts["read_workers"] == 3
    assert job.counts["range_rows"] == job.counts["rows_read"] == 120
    # 7 batches of 16 records in 3 ranges, then 8 records in 2
    assert sum(s.name == "read_range" for s in job.spans) == 7 * 3 + 2


@pytest.mark.parametrize("prune", [True, False])
def test_pooled_resume_matches_jax(tmp_path, monkeypatch, prune):
    """The port resumes the JAX package's checkpoint with the pool
    reading, to the JAX package's bytes."""
    _files(tmp_path, monkeypatch, nr=70, L=400, seed=77)
    _pooled(monkeypatch, 2, 5)
    _resume_jax_checkpoint(monkeypatch, prune)
    c = observe.jobs()[-1].counts
    assert c["read_workers"] == 2 and c["range_rows"] == c["rows_read"]


@pytest.mark.parametrize("form", ["single", "mixed"])
def test_pooled_ingest_equals_serial_and_jax(tmp_path, monkeypatch, form):
    """The store of the pooled read, of the serial read of the same text
    gzipped under the same name (the store keeps its sources' names),
    and of the JAX package: equal file for file."""
    names, seqs = _genomes(6, 37, 301)
    text = _text(names, seqs, form)
    (tmp_path / "db.fa").write_bytes(text)
    (tmp_path / "gz").mkdir()
    (tmp_path / "gz" / "db.fa").write_bytes(gzip.compress(text))
    _pooled(monkeypatch, 3, 3)
    monkeypatch.chdir(tmp_path / "gz")
    pstore.ingest(["db.fa"], str(tmp_path / "serial.uvst"), block=8)
    monkeypatch.chdir(tmp_path)
    with observe.job("ingest") as job:
        pstore.ingest(["db.fa"], "pool.uvst", block=8)
    assert job.counts["range_rows"] == 37
    _same_dirs(tmp_path / "serial.uvst", tmp_path / "pool.uvst")
    jstore.ingest(["db.fa"], "jax.uvst", block=8)
    _same_dirs(tmp_path / "jax.uvst", tmp_path / "pool.uvst")


@pytest.mark.parametrize("case", ["pooled", "gzip", "below_threshold"])
def test_nearest_job_counts_the_pool(tmp_path, monkeypatch, case):
    """The job's counters: the pool's size and the records it parsed
    (= rows_read) when it reads the archive, both 0 when it does not."""
    _files(tmp_path, monkeypatch)
    db = "db.fa"
    if case == "gzip":
        db = "db.fa.gz"
        with open("db.fa", "rb") as src, gzip.open(db, "wb") as dst:
            dst.write(src.read())
    _pooled(monkeypatch, 2, 500 if case == "below_threshold" else 9)
    assert port_main(["nearest", "-r", db, "q.fa", "-n", "4", "-p", "16",
                      "-o", "out", "--device", "cpu"]) == 0
    c = observe.jobs()[-1].counts
    assert c["rows_read"] == 120
    if case == "pooled":
        assert c["read_workers"] == 2 and c["range_rows"] == 120
    else:
        assert c["read_workers"] == c["range_rows"] == 0
