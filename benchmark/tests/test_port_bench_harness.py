"""CPU tests of the benchmark harness (benchmark/): the traffic, the
frozen yardsticks, finding everything by name, the contract's result
line, the controls and planted faults, and the imports.

    python -m pytest benchmark/tests -q

The runs here use ``--device cpu --tiny``: the port's plain versions at
the workload files' tiny sizes.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.reference import align as ref_align  # noqa: E402
from benchmark.reference import nearest as ref_nearest  # noqa: E402
from benchmark.roofline import peaks  # noqa: E402
from benchmark.traffic import genomes as gen  # noqa: E402

CELLS = ("nearest.daily1000.store", "align.trimmed-ends")


def run_cli(*args, cwd=ROOT, timeout=300):
    env = dict(os.environ, BENCH_RUN="1")
    return subprocess.run([sys.executable, str(cwd / "benchmark" / "run.py"),
                           *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def tiny(cell, seed, *extra, cwd=ROOT):
    return run_cli("--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", extra[0] if extra else "0",
                   "--device", "cpu", "--tiny", *extra[1:], cwd=cwd)


def last_json(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ----------------------------------------------------------------------
# traffic


def _mix(name):
    return gen.load_mix(BENCH / "traffic" / f"{name}.json")


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 10**12 + 7])
def test_port_bench_traffic_is_a_function_of_the_seed(seed):
    mix = _mix("daily1000")
    comp = {"A": 0.299, "C": 0.184, "G": 0.196, "T": 0.321}
    a = gen.LineageTree(seed, 3000, comp, mix["lineages"])
    b = gen.LineageTree(seed, 3000, comp, mix["lineages"])
    ra = gen.aligned_rows(gen.rng_for(seed, 7), a, 40, mix)
    rb = gen.aligned_rows(gen.rng_for(seed, 7), b, 40, mix)
    assert np.array_equal(ra, rb)
    other = gen.aligned_rows(gen.rng_for(seed + 1, 7),
                             gen.LineageTree(seed + 1, 3000, comp,
                                             mix["lineages"]), 40, mix)
    assert not np.array_equal(ra, other)
    amix = _mix("trimmed-ends")
    qa = gen.assemblies(gen.rng_for(seed, 9), a, 30, amix)
    assert qa == gen.assemblies(gen.rng_for(seed, 9), b, 30, amix)


def test_port_bench_traffic_matches_its_mix():
    mix = _mix("daily1000")
    comp = {"A": 0.299, "C": 0.184, "G": 0.196, "T": 0.321}
    L = 29903
    tree = gen.LineageTree(11, L, comp, mix["lineages"])
    lo, hi = mix["lineages"]["founder_snps"]
    snps = (tree.founders != tree.backbone[None, :]).sum(1)
    assert len(snps) == mix["lineages"]["founders"]
    assert snps.min() >= lo and snps.max() <= hi
    share = {b: (tree.backbone == ord(b)).mean() for b in "ACGT"}
    assert all(abs(share[b] - comp[b]) < 0.01 for b in "ACGT")
    rows = gen.aligned_rows(gen.rng_for(11, 2), tree, 300, mix)
    assert (rows[:, :mix["mask_5prime"]] == ord("N")).all()
    tail = (rows[:, ::-1] != ord("N")).argmax(1)
    assert tail.min() >= mix["mask_3prime"][0]
    amb = np.isin(rows, gen.AMBIG).sum(1)
    assert amb.max() <= mix["genome"]["ambiguity"][1]
    # lineage sizes follow the Zipf weights: the largest lineage holds
    # about its weight's share of the genomes
    assert abs(sorted(tree.weights)[-1] - 1 / sum(
        1 / np.arange(1, 65) ** 1.1)) < 1e-9

    amix = _mix("trimmed-ends")
    atree = gen.LineageTree(11, L, comp, amix["lineages"])
    ind = amix["lineages"]["indels"]
    assert np.array_equal(atree.founders, tree.founders)
    counts = [len(x) for x in atree.indels]
    assert min(counts) == ind["count"][0] and max(counts) == ind["count"][1]
    for lineage in atree.indels:
        assert [p for p, _, _ in lineage] == sorted(
            (p for p, _, _ in lineage), reverse=True)
        for _, deleted, inserted in lineage:
            assert (deleted or len(inserted)) in ind["len"]
            assert not (deleted and inserted)
    qs = gen.assemblies(gen.rng_for(11, 3), atree, 400, amix)
    assert all(ref_align.qc(q, L, 0.5) for q in qs)
    assert all(q[:1] != b"N" and q[-1:] != b"N" for q in qs)
    # the uncovered ends stripped (54 + 67 sites), lineage indels of at
    # most 5 x 9 bases either way, and a dropout at an end stripped too
    uncovered = amix["mask_5prime"] + amix["mask_3prime"][0]
    offsets = np.array([len(q) - L for q in qs])
    assert offsets.max() <= -uncovered + 45
    assert offsets.min() >= -uncovered - 45 - 2 * 300
    assert np.median(offsets) >= -uncovered - 45


def test_port_bench_reference_trims_as_uvaia():
    c = np.arange(1, 101, dtype=np.uint8).reshape(2, 50) % 15 + 1
    t = ref_nearest.trimmed(c, 7)
    assert (t[:, :7] == 0).all() and (t[:, -7:] == 0).all()
    assert np.array_equal(t[:, 7:-7], c[:, 7:-7])
    assert np.array_equal(ref_nearest.trimmed(c, 0), c)
    # cut to int(L / 2.1) = 23 sites a side
    assert (ref_nearest.trimmed(c, 40)[:, :23] == 0).all()
    assert (ref_nearest.trimmed(c, 40)[:, 23:27] != 0).all()


# ----------------------------------------------------------------------
# frozen yardsticks


def test_port_bench_roofline_counts_match_hand_sums():
    w = peaks.counter_work(rows=10, queries=3, sites=7, launches=2)
    assert w["int8_ops"] == 2 * 10 * 3 * 9 * 7
    assert w["nbytes"] == 10 * 7 + 2 * 3 * 7 + 3 * 10 * 3 * 4 + 2 * 7 + 20 * 10
    g = peaks.gotoh_forward_work(n=5, widths=[129, 257], query_bytes=11)
    assert g["int32_ops"] == 10 * 5 * (129 + 257)
    assert g["nbytes"] == 5 + 11 + 32 + 5 * (129 + 257)
    assert peaks.bound_s(3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(0, int8_ops=1979e12) == pytest.approx(1.0)
    forward = harness.load_module(BENCH / "roofline" / "align_forward.py")
    assert [forward.band_width(1000, m) for m in (1000, 952, 1100, 1500,
                                                  400)] == \
        [129, 129, 257, 2 * 516 + 1, 2 * 616 + 1]


def test_port_bench_reference_matches_frozen_oracles():
    rng = np.random.default_rng(3)
    letters = np.frombuffer(b"ACGTACGTACGTRYN", np.uint8)
    db = ref_nearest.codes(letters[rng.integers(0, len(letters), (60, 90))])
    q = ref_nearest.codes(letters[rng.integers(0, len(letters), (4, 90))])
    want_s, want_i = ref_nearest.oracle_topk(db, q, 7)
    scorer = ref_nearest.Scorer(db, "cpu", block=16)
    nonconst = ref_nearest.nonconstant_sites(q)
    for k in range(4):
        rows, s = ref_nearest.topk(scorer, q[k], nonconst, np.arange(60), 7)
        assert np.array_equal(rows, want_i[k])
        assert np.array_equal(s, want_s[k])
    ref = bytes(letters[rng.integers(0, 4, 120)])
    qs = [ref[:40] + ref[47:], ref[5:] + b"GATTACA", ref[:60] + b"NNNN"
          + ref[64:110]]
    rows = ref_align.control_rows(ref, qs, "cpu", saturate=None)
    for (opt, own), qq in zip(ref_align.judge(ref, qs, rows, "cpu"), qs):
        assert opt == own == ref_align.oracle_score(ref, qq)


# ----------------------------------------------------------------------
# finding things by name


def test_port_bench_finds_everything_by_name():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in spec["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert (BENCH / "drivers" / f"{cell.workload['driver']}.py").exists()
        assert cell.end_to_end and cell.per_layer
    spans = {n for p in (BENCH / "spans").glob("*.json")
             for n in json.loads(p.read_text())}
    for m in spec["end_to_end"] + spec["per_layer"]:
        s = harness.Cell.metric_spec(m["name"])
        assert (BENCH / "readers" / f"{s['reader']}.py").exists()
        assert set(s.get("spans", ())) <= spans
        if "work" in s:
            assert (BENCH / "roofline" / f"{s['work']}.py").exists()
    for p in (BENCH / "spans").glob("*.json"):
        for targets in json.loads(p.read_text()).values():
            for t in targets:
                harness.Spans.resolve(t["target"])


def test_port_bench_refuses_an_unknown_cell():
    proc = run_cli("--workload", "no.such.cell", "--seed", "1",
                   "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_port_bench_refuses_to_run_without_a_card():
    if harness_has_cuda():
        pytest.skip("a CUDA device is present")
    proc = run_cli("--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0")
    assert proc.returncode != 0 and not proc.stdout.strip()


def harness_has_cuda() -> bool:
    import torch
    return torch.cuda.is_available()


# ----------------------------------------------------------------------
# whole runs on the CPU


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_port_bench_run_prints_the_contract_line(cell, trace):
    res = last_json(tiny(cell, 2**33 + 17, trace))
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(res["device"])
    c = harness.Cell(cell)
    names = {m["name"] for m in (c.per_layer if trace == "1"
                                 else c.end_to_end)}
    assert set(res["metrics"]) <= names
    if trace == "0":
        assert set(res["metrics"]) == names
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert res["attempted"] >= 2            # the window, then one more
    assert "process_cores" in res["host"]
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_port_bench_control_is_not_correct(cell):
    res = last_json(tiny(cell, 99, "0", "--control"))
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


def test_port_bench_a_cell_is_added_by_files_alone(tmp_path):
    """A new traffic mix, cell, metric and reader as new files and new
    entries in BENCHMARK.json: the copy runs the new cell and reports the
    new metric, and no file that was there changed."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "uvaia_tpu_torch").symlink_to(ROOT / "uvaia_tpu_torch")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = tmp_path / "benchmark"
    mix = json.loads((b / "traffic" / "daily1000.json").read_text())
    mix["queries_per_job"] = 64
    (b / "traffic" / "outbreak64.json").write_text(json.dumps(mix))
    work = json.loads((b / "workloads" / "nearest.daily1000.store.json")
                      .read_text())
    (b / "workloads" / "nearest.outbreak64.store.json").write_text(
        json.dumps(work))
    (b / "readers" / "jobs_done.py").write_text(
        "def read(run, spec):\n"
        "    return float(sum(j['rc'] == 0 for j in run.jobs))\n")
    (b / "metrics" / "nearest.jobs_done.json").write_text(
        json.dumps({"reader": "jobs_done"}))
    spec["workloads"].append({"name": "nearest.outbreak64.store",
                              "config": "sarscov2-nearest",
                              "traffic": "outbreak64", "chips": 1,
                              "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("nearest.outbreak64.store")
    spec["per_layer"].append({"name": "nearest.jobs_done", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "genomes_per_s",
                              "workloads": ["nearest.outbreak64.store"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    res = last_json(tiny("nearest.outbreak64.store", 5, "1", cwd=tmp_path))
    assert res["correct"] and res["metrics"]["nearest.jobs_done"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data


def test_port_bench_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and benchmark/, a run
    exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = tiny(CELLS[0], 1, cwd=tmp_path)
    assert proc.returncode != 0 and not proc.stdout.strip()


# ----------------------------------------------------------------------
# planted faults: the timed path broken underneath, correct comes out
# false (one chip: no exchange between chips to leave out)


def _fault_run(monkeypatch, capsys, cell, seed=31):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.5", "--trace", "0", "--device", "cpu", "--tiny"],
                      0.0)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _nearest_fault(monkeypatch, kind):
    import torch
    from uvaia_tpu_torch.engine import nearest as eng
    from uvaia_tpu_torch.io import store
    from uvaia_tpu_torch.ops import scan
    if kind == "state unchanged":
        flush = scan.flush_survivors

        def frozen(qd, state, *a, **kw):
            _, flags = flush(qd, state, *a, **kw)
            return state, torch.zeros_like(flags)
        monkeypatch.setattr(scan, "flush_survivors", frozen)
    elif kind == "half the batch":
        batches = store.StoreStreamer._batches

        def half(self):
            for batch, payload in batches(self):
                batch.ok[1::2] = False
                yield batch, payload
        monkeypatch.setattr(store.StoreStreamer, "_batches", half)
    else:
        rows = eng.NearestResult.rows

        def altered(self):
            for row in rows(self):
                if row[2] == 1:
                    row = (*row[:3], row[3] + 1, *row[4:])
                yield row
        monkeypatch.setattr(eng.NearestResult, "rows", altered)


def _align_fault(monkeypatch, kind):
    import numpy as np
    from uvaia_tpu_torch.engine import align as eng
    from uvaia_tpu_torch.io import fasta
    from uvaia_tpu_torch.ops import gotoh
    if kind == "state unchanged":
        decode = gotoh.decode_events

        def unchanged(q, ref, *a, **kw):
            row, cost = decode(q, ref, *a, **kw)
            return (None if row is None else ref.copy()), cost
        monkeypatch.setattr(gotoh, "decode_events", unchanged)
    elif kind == "half the batch":
        qc = eng._qc
        seen = {"n": 0}

        def half(rec, *a, **kw):
            seen["n"] += 1
            return qc(rec, *a, **kw) and seen["n"] % 2 == 0
        monkeypatch.setattr(eng, "_qc", half)
    else:
        write = fasta.ParallelXzFastaWriter.write

        def altered(self, name, seq):
            s = bytearray(seq)
            s[len(s) // 2] = ord("A") if s[len(s) // 2] != ord("A") \
                else ord("C")
            return write(self, name, bytes(s))
        monkeypatch.setattr(fasta.ParallelXzFastaWriter, "write", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["state unchanged", "half the batch",
                                  "answer altered"])
def test_port_bench_planted_fault_is_not_correct(monkeypatch, capsys, cell,
                                                 kind):
    (_nearest_fault if cell.startswith("nearest") else _align_fault)(
        monkeypatch, kind)
    res = _fault_run(monkeypatch, capsys, cell)
    assert res["correct"] is False, res["checks"]


def test_port_bench_nearest_check_holds_the_trim(monkeypatch, capsys):
    """The program run at trim 0 against the reference at the cell's trim
    reads not correct: the trim is compared, not assumed."""
    drv = harness.load_module(BENCH / "drivers" / "nearest.py")
    argv = drv._argv

    def untrimmed(run, *a):
        out = argv(run, *a)
        out[out.index("--trim") + 1] = "0"
        return out
    monkeypatch.setattr(drv, "_argv", untrimmed)
    res = _fault_run(monkeypatch, capsys, CELLS[0])
    assert res["correct"] is False and \
        res["checks"]["csv_rows_wrong"]["value"] > 0


def test_port_bench_span_shares_read_the_window_alone():
    """Span shares count the window's jobs and leave out the profiled
    job after it."""
    spans = harness.Spans()
    jobs = [{"t0_ns": 0, "t1_ns": 100}, {"t0_ns": 100, "t1_ns": 200},
            {"t0_ns": 200, "t1_ns": 900, "profiled": True}]
    for iv in ((10, 30), (20, 40), (150, 160), (300, 800)):
        spans._add("output", *iv)
    run = harness.Run.__new__(harness.Run)
    run.jobs, run.spans = jobs, spans
    reader = harness.load_module(BENCH / "readers" / "span_share.py")
    assert reader.read(run, {"spans": ["output"]}) == pytest.approx(20.0)
    assert reader.read(run, {"spans": ["missing"]}) is None


# ----------------------------------------------------------------------
# imports


FORBIDDEN = {"jax", "jaxlib", "uvaia_tpu"}


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_port_bench_imports_no_jax():
    files = list(BENCH.rglob("*.py"))
    for p in files:
        bad = _imports(p) & FORBIDDEN
        assert not bad, (p, bad)
    for p in (BENCH / "reference").rglob("*.py"):
        assert "uvaia_tpu_torch" not in _imports(p), p
    code = f"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {sorted(FORBIDDEN)!r}:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness
from pathlib import Path
for p in sorted(Path({str(BENCH)!r}).rglob('*.py')):
    if 'tests' in p.parts or p.name in ('run.py', '__init__.py'):
        continue
    harness.load_module(p)
import benchmark.reference.nearest, benchmark.reference.align
import uvaia_tpu_torch.cli, uvaia_tpu_torch.engine.nearest
import uvaia_tpu_torch.engine.align
bad = sorted({{m.split('.')[0] for m in sys.modules}}
             & set({sorted(FORBIDDEN)!r}))
assert not bad, bad
print('ok')
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
