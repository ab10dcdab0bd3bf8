"""Job driver of `nearest` cells.

Set-up: the lineage tree and the database from the seed, the database
written as FASTA, indexed by the program's `ingest` into its store
(``database: "store"``) and the FASTA deleted, the prepared query
batches written, and one warm-up job with a batch of its own.  A job
is ``uvaia_tpu_torch.cli.main(["nearest", ...])`` in this process, as
a user's command line; its units are the database rows streamed.

The check (after the window): for each completed job, the CSV's query
order and row counts against the reference's QC and resolution order,
the rows of a sample of queries (drawn from the seed, with the least
resolved query of each job) against the plain reference's six scores
and ranking at the configuration's trim, and every final neighbour present in the dump with its
sequence (a sample's sequences compared with the generated letters).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

from benchmark import outputs
from benchmark.reference import nearest as ref
from benchmark.traffic import genomes as gen


def _argv(run, store: str, qfile: str, prefix: str) -> list[str]:
    c = run.config
    argv = ["nearest", "-r", store, qfile, "-n", str(c["nbest"]),
            "-p", str(c["pool"]), "-a", str(c["query_ambiguity"]),
            "-A", str(c["ref_ambiguity"]), "--trim", str(c["trim"]),
            "--codec", c["codec"], "-o", prefix, "--device", run.device]
    return argv if c["prune"] else argv + ["--no-prune"]


def setup(run):
    from uvaia_tpu_torch import cli

    c, mix = run.config, run.traffic
    st = SimpleNamespace()
    st.run = run
    with run.phase("set-up: database generated and written"):
        tree = gen.LineageTree(run.seed, c["length"], c["composition"],
                               mix["lineages"])
        st.db = gen.aligned_rows(gen.rng_for(run.seed, gen.STREAM_DATABASE),
                                 tree, c["db_rows"], mix)
        st.db_names = [f"db{i}" for i in range(c["db_rows"])]
        fa = run.work / "db.fa"
        gen.write_fasta(fa, st.db_names, st.db)
    database = run.workload["database"]
    if database == "store":
        st.db_path = str(run.work / "db.uvst")
        with run.phase("set-up: ingest"):
            rec = run.call_program(cli.main, ["ingest", str(fa), "-o",
                                              st.db_path, "--block",
                                              str(c["store_block"])])
        os.remove(fa)
        if rec["rc"] != 0:
            return None
    else:
        st.db_path = str(fa)
    Q = mix["queries_per_job"]
    st.queries = []
    with run.phase("set-up: query batches"):
        _queries(run, st, tree, Q)
    with run.phase("set-up: warm-up"):
        ok = _warm_up(run, st, tree, Q)
    return st if ok else None


def _queries(run, st, tree, Q):
    c, mix = run.config, run.traffic
    for j in range(mix["jobs_prepared"]):
        q = gen.aligned_rows(gen.rng_for(run.seed, gen.STREAM_JOB0 + j),
                             tree, Q, mix)
        names = [f"j{j}q{i}" for i in range(Q)]
        path = run.work / f"q{j}.fa"
        gen.write_fasta(path, names, q)
        kept = ref.query_qc(ref.codes(q), c["query_ambiguity"])
        st.queries.append((str(path), names, q, kept))


def _warm_up(run, st, tree, Q) -> bool:
    """One whole job of a batch of its own, as the window runs them."""
    from uvaia_tpu_torch import cli
    warm = gen.aligned_rows(gen.rng_for(run.seed, gen.STREAM_WARMUP), tree,
                            Q, run.traffic)
    wpath = run.work / "warm.fa"
    gen.write_fasta(wpath, [f"w{i}" for i in range(Q)], warm)
    return run.call_program(cli.main, _argv(run, st.db_path, str(wpath),
                                            str(run.work / "warm")))["rc"] == 0


def run_job(st, j: int) -> dict:
    from uvaia_tpu_torch import cli
    run = st.run
    k = j % len(st.queries)
    qfile, names, _, kept = st.queries[k]
    prefix = str(run.work / f"job{j}")
    if run.control:
        rec = {"rc": 0, "log": "", "t0": 0.0, "t1": 0.0, "t0_ns": 0,
               "t1_ns": 0}
    else:
        rec = run.job(cli.main, _argv(run, st.db_path, qfile, prefix))
    rec.update(units=run.config["db_rows"],
               facts={"queries": int(kept.sum()), "batch": k,
                      "prefix": prefix})
    return rec


def _sample(run, j: int, qcodes: np.ndarray, kept_idx: np.ndarray):
    """Query rows (indices into the batch) compared in job j: a draw
    from the seed and the least resolved query."""
    n = run.workload["check"]["queries_per_job"]
    rng = gen.rng_for(run.seed, gen.STREAM_SAMPLE * 1000 + j)
    pick = set(rng.choice(kept_idx, size=min(n, len(kept_idx)),
                          replace=False).tolist())
    pick.add(int(kept_idx[np.argmin((qcodes[kept_idx] != 0).sum(1))]))
    return sorted(pick)


def check(st, jobs) -> dict:
    run = st.run
    c = run.config
    k = c["nbest"]
    db_codes = ref.codes(st.db)
    valid_rows = np.nonzero(ref.db_valid(db_codes, c["ref_ambiguity"]))[0]
    scorer = ref.Scorer(db_codes, run.device)
    ctrl = ref.Scorer(ref.ambiguity_as_n(db_codes), run.device) \
        if run.control else None
    index = {nm: r for r, nm in enumerate(st.db_names)}
    rows_wrong = shape_wrong = dump_wrong = 0
    for j, job in enumerate(jobs):
        if job["rc"] != 0:
            continue
        _, names, q_letters, kept = st.queries[job["facts"]["batch"]]
        qcodes = ref.trimmed(ref.codes(q_letters), c["trim"])
        kept_idx = np.nonzero(kept)[0]
        order = kept_idx[ref.query_order(qcodes[kept_idx])]
        nonconst = ref.nonconstant_sites(qcodes[kept_idx])
        sample = _sample(run, j, qcodes, kept_idx)
        want = {names[i]: ref.topk(scorer, qcodes[i], nonconst, valid_rows,
                                   k) for i in sample}
        if run.control:
            cq = ref.ambiguity_as_n(qcodes)
            cnc = ref.nonconstant_sites(cq[kept_idx])
            got = {}
            for i in sample:
                rows, sc = ref.topk(ctrl, cq[i], cnc, valid_rows, k)
                got[names[i]] = [[names[i], st.db_names[r], str(rk + 1),
                                  *map(str, s)]
                                 for rk, (r, s) in enumerate(zip(rows, sc))]
        else:
            prefix = job["facts"]["prefix"]
            _, csv = outputs.csv_rows(prefix + ".csv.xz")
            by_q: dict[str, list] = {}
            for row in csv:
                by_q.setdefault(row[0], []).append(row)
            expect_n = min(k, len(valid_rows))
            csv_order = list(by_q)
            shape_wrong += sum(a != b for a, b in zip(
                csv_order, [names[i] for i in order]))
            shape_wrong += abs(len(csv_order) - len(order))
            shape_wrong += sum(len(v) != expect_n for v in by_q.values())
            got = {names[i]: by_q.get(names[i], []) for i in sample}
            dump = dict(outputs.fasta_records(prefix + ".aln.xz"))
            dump_wrong += sum(row[1] not in dump for row in csv)
            for nm in got:
                for row in got[nm]:
                    seq = dump.get(row[1])
                    r = index.get(row[1])
                    if seq is not None and r is not None and \
                            seq != st.db[r].tobytes():
                        dump_wrong += 1
        for nm, (rows, sc) in want.items():
            have = got[nm]
            rows_wrong += abs(len(have) - len(rows))
            for rk, (r, s, h) in enumerate(zip(rows, sc, have)):
                expect = [nm, st.db_names[r], str(rk + 1), *map(str, s)]
                rows_wrong += h != expect
    return {"csv_rows_wrong": (rows_wrong, 0),
            "csv_shape_wrong": (shape_wrong, 0),
            "dump_wrong": (dump_wrong, 0)}
