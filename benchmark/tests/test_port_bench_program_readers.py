"""CPU tests of the readers of the program's own trace
(benchmark/readers/program_*.py) on synthetic records.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from uvaia_tpu_torch.utils import observe  # noqa: E402

S = observe.SpanRecord
MAIN, OTHER = 1, 2


def _job(jid, t0, t1, spans, counts=None):
    root = S("nearest", jid * 100, None, jid, MAIN, t0, t1)
    spans = [S(n, jid * 100 + k + 1, jid * 100 if p is None else
               jid * 100 + p + 1, jid, th, a, b, dev)
             for k, (n, p, th, a, b, dev) in enumerate(spans)]
    return observe.JobRecord(jid, "nearest", root, spans, counts or {})


def _run(jobs, trace=None):
    run = harness.Run.__new__(harness.Run)
    run.jobs, run.trace_data = jobs, trace
    return run


def _reader(name):
    return harness.load_module(BENCH / "readers" / f"{name}.py")


# two window jobs of 100 ns each, then a profiled job
JOBS = [{"t0_ns": 0, "t1_ns": 100}, {"t0_ns": 100, "t1_ns": 200},
        {"t0_ns": 200, "t1_ns": 1200, "profiled": True}]


def _program():
    # (name, parent index or None for the root, thread, t0, t1, device)
    return [
        _job(1, 2, 98, [("csv", None, MAIN, 10, 40, None),
                        ("dump_write", 0, MAIN, 20, 30, None),   # in csv
                        ("forward", None, MAIN, 50, 55, 30),
                        ("stream_read", None, OTHER, 0, 90, None)],
             {"redo_rows": 1, "forward_rows": 10}),
        _job(2, 101, 199, [("csv", None, MAIN, 110, 130, None)],
             {"redo_rows": 3, "forward_rows": 10}),
        _job(3, 205, 1190, [("query_pack", None, MAIN, 300, 500, None),
                            ("csv", None, MAIN, 700, 900, None),
                            ("dump_write", 1, MAIN, 800, 850, None),
                            ("stream_read", None, OTHER, 500, 700, None)]),
    ]


def test_program_span_reads_self_and_device_time(monkeypatch):
    monkeypatch.setattr(observe, "jobs", _program)
    read = _reader("program_span").read
    # csv: (30 - 10) + 20 over 200 ns of window jobs; the profiled job
    # is left out
    assert read(_run(JOBS), {"program_spans": ["csv"]}) == \
        pytest.approx(20.0)
    assert read(_run(JOBS), {"program_spans": ["dump_write", "csv"]}) == \
        pytest.approx(25.0)
    assert read(_run(JOBS), {"program_spans": ["forward"]}) == \
        pytest.approx(15.0)                 # the stream time, 30 ns
    assert read(_run(JOBS), {"program_spans": ["retain"]}) == 0.0


def test_program_count_sums_over_the_window(monkeypatch):
    monkeypatch.setattr(observe, "jobs", _program)
    spec = {"numerator": ["redo_rows"], "denominator": ["forward_rows"]}
    assert _reader("program_count").read(_run(JOBS), spec) == \
        pytest.approx(20.0)
    assert _reader("program_count").read(
        _run(JOBS), {"numerator": ["redo_rows"],
                     "denominator": ["none"]}) is None


def test_program_idle_reads_the_profiled_job(monkeypatch):
    monkeypatch.setattr(observe, "jobs", _program)
    # one kernel 400..600 in the profiled job: idle 200..400 and
    # 600..1200, clipped to the job; main-thread spans cover 300..500
    # and 700..900 (the reader thread's span explains nothing)
    trace = harness.Trace([("k", 400, 600)], 150, 1250)
    value = _reader("program_idle").read(_run(JOBS, trace), {})
    idle = (400 - 200) + (1200 - 600)
    assert value == pytest.approx(100.0 * (idle - 100 - 200) / idle)
    assert _reader("program_idle").read(_run(JOBS), {}) is None


@pytest.mark.parametrize("reader,spec", [
    ("program_span", {"program_spans": ["csv"]}),
    ("program_count", {"numerator": ["redo_rows"],
                       "denominator": ["forward_rows"]}),
    ("program_idle", {})])
def test_program_readers_read_none_without_a_record(monkeypatch, reader,
                                                    spec):
    """A window job with no program record, or a program with no
    records at all, reads None."""
    trace = harness.Trace([("k", 400, 600)], 150, 1250)
    monkeypatch.setattr(observe, "jobs", lambda: _program()[1:2])
    jobs = JOBS[:2] + [dict(JOBS[2], t0_ns=1300, t1_ns=1400)]
    assert _reader(reader).read(_run(jobs, trace), spec) is None
    monkeypatch.delattr(observe, "jobs")
    assert _reader(reader).read(_run(JOBS, trace), spec) is None
