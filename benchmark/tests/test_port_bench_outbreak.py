"""CPU tests of the cell `nearest.outbreak64.fasta` (uvaia's own
deployment: an outbreak batch against a raw aligned FASTA archive):
tiny whole runs and their control, the outbreak batches' lineages, the
pool-share reader and the rebuild's roofline on hand-made records.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.roofline import peaks  # noqa: E402
from benchmark.traffic import genomes as gen  # noqa: E402
from test_port_bench_harness import last_json, tiny  # noqa: E402
from test_port_bench_program_readers import JOBS, _job, _run  # noqa: E402
from uvaia_tpu_torch.utils import observe  # noqa: E402

CELL = "nearest.outbreak64.fasta"
NEW = {"nearest.stream_read_pct", "nearest.delta_encode_pct"}


@pytest.mark.parametrize("trace", ["0", "1"])
def test_outbreak_cell_runs_correct(trace):
    res = last_json(tiny(CELL, 2**40 + 3, trace))
    assert res["correct"] is True and res["failed"] == 0
    cell = harness.Cell(CELL)
    if trace == "0":
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        return
    assert NEW <= set(res["metrics"])
    for name in NEW:
        assert 0 < res["metrics"][name]["value"] <= 100


def test_outbreak_control_is_not_correct():
    res = last_json(tiny(CELL, 77, "0", "--control"))
    assert res["correct"] is False
    assert res["checks"]["csv_rows_wrong"]["value"] > 0


def _nearest_founder(tree, rows: np.ndarray) -> np.ndarray:
    """Each row's closest founder over its resolved bases."""
    base = np.isin(rows, gen.ACGT)
    diff = (rows[:, None, :] != tree.founders[None, :, :]) & base[:, None, :]
    return diff.sum(2).argmin(1)


def test_outbreak_batches_hold_one_lineage_the_same_for_every_seed():
    drv = harness.load_module(BENCH / "drivers" / "nearest_outbreak.py")
    mix = gen.load_mix(BENCH / "traffic" / "outbreak64-one-lineage.json")
    cfg = harness.load_json(BENCH / "configs" / "sarscov2-nearest-fasta.json")
    for seed in (5, 2**35 + 11):
        tree = gen.LineageTree(seed, 3000, cfg["composition"],
                               mix["lineages"])
        run = SimpleNamespace(seed=seed, traffic=mix)
        for j in range(mix["jobs_prepared"]):
            q = drv.outbreak(run, tree, j, mix["queries_per_job"])
            assert q.shape == (mix["queries_per_job"], 3000)
            # lineage index j is Zipf rank j + 1: the weights fall
            assert tree.weights[j] == np.sort(tree.weights)[::-1][j]
            assert (_nearest_founder(tree, q) == j).all(), (seed, j)
        # the database is drawn across the lineages
        db = gen.aligned_rows(gen.rng_for(seed, gen.STREAM_DATABASE), tree,
                              200, mix)
        assert len(set(_nearest_founder(tree, db))) > mix["jobs_prepared"]


def test_pool_span_reads_the_pool_share(monkeypatch):
    # two pool threads (2, 3) and the reader thread (4)
    monkeypatch.setattr(observe, "jobs", lambda: [
        _job(1, 2, 98, [("delta_encode", None, 2, 0, 40, None),
                        ("delta_encode", None, 3, 10, 30, None),
                        ("stream_read", None, 4, 0, 90, None)],
             {"encode_workers": 2}),
        _job(2, 101, 199, [("delta_encode", None, 2, 120, 150, None)],
             {"encode_workers": 2})])
    read = harness.load_module(BENCH / "readers" / "pool_span.py").read
    spec = {"program_spans": ["delta_encode"], "workers": "encode_workers"}
    # (40 + 20 + 30) ns over 2 workers x 200 ns of window jobs
    assert read(_run(JOBS), spec) == pytest.approx(22.5)
    assert read(_run(JOBS), dict(spec, workers="none")) is None
    monkeypatch.delattr(observe, "jobs")
    assert read(_run(JOBS), spec) is None


def test_rebuild_roofline_counts_match_hand_sums(monkeypatch):
    work = harness.load_module(BENCH / "roofline" / "nearest_rebuild.py")
    assert work.rebuild_bytes(slots=10, rows=4, sites=7, launches=2) == \
        3 * 10 + 7 * 4 + 7 * 2
    counts = {"delta_slots": 4096 * 256, "delta_rows": 4096}
    monkeypatch.setattr(observe, "jobs", lambda: [
        _job(3, 205, 1190, [], counts)])
    run = _run(JOBS)
    run.config = {"length": 29903}
    want = (3 * 4096 * 256 + 29903 * 4096 + 29903) / peaks.BYTES_PER_S
    assert work.bound_s(run, 1) == pytest.approx(want)
    monkeypatch.setattr(observe, "jobs", lambda: [_job(3, 205, 1190, [])])
    assert work.bound_s(run, 1) is None
    # through the reader: the bound over the kernel's time in the trace
    monkeypatch.setattr(observe, "jobs", lambda: [
        _job(3, 205, 1190, [], counts)])
    t = int(round(2e9 * want))
    run.trace_data = harness.Trace(
        [("void delta_rebuild_kernel<unsigned short>(...)", 300, 300 + t),
         ("counters_kernel", 0, 10)], 0, 10**10)
    reader = harness.load_module(BENCH / "readers" / "kernel_roofline.py")
    spec = harness.Cell.metric_spec("nearest.rebuild_roofline")
    assert reader.read(run, spec) == pytest.approx(50.0, rel=1e-4)
