"""The port's `nearest` on a raw aligned FASTA archive, as upstream uvaia
runs it (no store: the reader, QC and host delta encoder on the path),
for an outbreak's batch of one-lineage queries: every CSV row (query
order, rank and the six scores) and every dump record held against the
benchmark's plain reference (benchmark/reference/nearest.py), at a
small size on the CPU, with one and two encode workers and the prune
on and off.  The genomes come from the benchmark's generator
(benchmark/traffic/genomes.py) with a fixed seed."""

import numpy as np
import pytest

from benchmark import outputs
from benchmark.drivers.nearest_outbreak import one_lineage
from benchmark.reference import nearest as ref
from benchmark.traffic import genomes as gen
from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.utils import observe

SEED = 20200101
L, DB_ROWS, Q, K, POOL, TRIM = 1200, 300, 8, 10, 32, 30
AMBIGUITY = 0.5
COMPOSITION = {"A": 0.299, "C": 0.184, "G": 0.196, "T": 0.321}
MIX = {"lineages": {"founders": 4, "founder_snps": [4, 10], "zipf_s": 1.1},
       "genome": {"private_snps": 6, "ambiguity": [0, 4],
                  "dropouts": [0, 2], "dropout_len": [10, 30]},
       "mask_5prime": 5, "mask_3prime": [6, 6]}


def _data(tmp_path):
    tree = gen.LineageTree(SEED, L, COMPOSITION, MIX["lineages"])
    db = gen.aligned_rows(gen.rng_for(SEED, gen.STREAM_DATABASE), tree,
                          DB_ROWS, MIX)
    q = gen.aligned_rows(gen.rng_for(SEED, gen.STREAM_JOB0),
                         one_lineage(tree, 1), Q, MIX)
    db_names = [f"db{i}" for i in range(DB_ROWS)]
    q_names = [f"q{i}" for i in range(Q)]
    gen.write_fasta(tmp_path / "db.fa", db_names, db)
    gen.write_fasta(tmp_path / "q.fa", q_names, q)
    return db, db_names, q, q_names


def _expected(db, db_names, q, q_names):
    """The reference's CSV rows, queries in the program's order."""
    db_codes = ref.codes(db)
    valid_rows = np.nonzero(ref.db_valid(db_codes, AMBIGUITY))[0]
    kept = np.nonzero(ref.query_qc(ref.codes(q), AMBIGUITY))[0]
    qcodes = ref.trimmed(ref.codes(q), TRIM)
    order = kept[ref.query_order(qcodes[kept])]
    nonconst = ref.nonconstant_sites(qcodes[kept])
    scorer = ref.Scorer(db_codes, "cpu")
    rows = []
    for i in order:
        top, scores = ref.topk(scorer, qcodes[i], nonconst, valid_rows, K)
        rows += [[q_names[i], db_names[r], str(rank + 1), *map(str, s)]
                 for rank, (r, s) in enumerate(zip(top, scores))]
    return rows


@pytest.mark.parametrize("prune", [True, False], ids=["prune", "no_prune"])
@pytest.mark.parametrize("workers", [1, 2])
def test_outbreak_on_raw_fasta_matches_the_reference(tmp_path, monkeypatch,
                                                    workers, prune):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("UVAIA_TPU_ENCODE_THREADS", str(workers))
    db, db_names, q, q_names = _data(tmp_path)
    argv = ["nearest", "-r", "db.fa", "q.fa", "-n", str(K), "-p", str(POOL),
            "-a", str(AMBIGUITY), "-A", str(AMBIGUITY), "--trim", str(TRIM),
            "-o", "out", "--device", "cpu"]
    assert port_main(argv + ([] if prune else ["--no-prune"])) == 0
    counts = observe.jobs()[-1].counts
    assert counts["encode_workers"] == workers
    assert counts["delta_batches"] == counts["batches"] == \
        -(-(counts["rows_read"] - counts["rows_invalid"]) // POOL)

    _, csv = outputs.csv_rows("out.csv.xz")
    want = _expected(db, db_names, q, q_names)
    assert len(want) == Q * K
    assert csv == want
    dump = dict(outputs.fasta_records("out.aln.xz"))
    index = {nm: r for r, nm in enumerate(db_names)}
    assert {row[1] for row in csv} <= set(dump)
    for name, seq in dump.items():
        assert seq == db[index[name]].tobytes(), name
