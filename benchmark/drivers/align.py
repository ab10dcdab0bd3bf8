"""Job driver of `align` cells.

Set-up: the lineage tree from the seed, its backbone written as the
reference, the prepared batches of assemblies written, and one warm-up
job of a batch of its own.  A job is ``uvaia_tpu_torch.cli.main
(["align", ...])`` in this process, as a user's command line; its units
are the assemblies read (QC rejects count: the tool read and checked
them).

The check (after the window): for each completed job, the names of the
emitted rows against the reference's QC decisions (all rows, in order),
and a sample of rows (drawn from the seed, with the job's row of the
largest length offset) judged by the plain reference: the emitted row
has to be the projection of an alignment of least cost.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from benchmark import outputs
from benchmark.reference import align as ref
from benchmark.traffic import genomes as gen


def _argv(run, rfile: str, qfile: str, prefix: str) -> list[str]:
    c = run.config
    return ["align", "-r", rfile, qfile, "-p", str(c["pool"]),
            "--band", str(c["band"]), "-a", str(c["ambiguity"]),
            "--codec", c["codec"], "-o", prefix, "--device", run.device]


def _batch(run, tree, stream: int, n: int, tag: str):
    qs = gen.assemblies(gen.rng_for(run.seed, stream), tree, n, run.traffic)
    names = [f"{tag}{i}" for i in range(n)]
    L = tree.length
    kept = np.array([ref.qc(q, L, run.config["ambiguity"]) for q in qs])
    return names, qs, kept


def setup(run):
    from uvaia_tpu_torch import cli

    c, mix = run.config, run.traffic
    st = SimpleNamespace()
    st.run = run
    tree = gen.LineageTree(run.seed, c["length"], c["composition"],
                           mix["lineages"])
    st.ref = tree.backbone.tobytes()
    st.ref_path = str(run.work / "ref.fa")
    gen.write_fasta(run.work / "ref.fa", ["reference"], [st.ref])
    st.batches = []
    with run.phase("set-up: query batches"):
        for j in range(mix["jobs_prepared"]):
            names, qs, kept = _batch(run, tree, gen.STREAM_JOB0 + j,
                                     mix["queries_per_job"], f"j{j}a")
            path = run.work / f"q{j}.fa"
            gen.write_fasta(path, names, qs)
            st.batches.append((str(path), names, qs, kept))
    with run.phase("set-up: warm-up"):
        names, qs, _ = _batch(run, tree, gen.STREAM_WARMUP,
                              run.workload["warmup_queries"], "w")
        wpath = run.work / "warm.fa"
        gen.write_fasta(wpath, names, qs)
        rec = run.call_program(cli.main, _argv(run, st.ref_path, str(wpath),
                                               str(run.work / "warm")))
    return st if rec["rc"] == 0 else None


def run_job(st, j: int) -> dict:
    from uvaia_tpu_torch import cli
    run = st.run
    k = j % len(st.batches)
    qfile, names, qs, kept = st.batches[k]
    prefix = str(run.work / f"job{j}")
    if run.control:
        rec = {"rc": 0, "log": "", "t0": 0.0, "t1": 0.0, "t0_ns": 0,
               "t1_ns": 0}
    else:
        rec = run.job(cli.main, _argv(run, st.ref_path, qfile, prefix))
    rec.update(units=len(names),
               facts={"batch": k, "prefix": prefix,
                      "passed_lengths": [len(q) for q, ok in zip(qs, kept)
                                         if ok]})
    return rec


def _sample(run, j: int, qs, kept_idx: np.ndarray, n_ref: int):
    """Rows compared in job j: a draw from the seed and the row of the
    largest length offset (the widest band)."""
    n = run.workload["check"]["rows_per_job"]
    rng = gen.rng_for(run.seed, gen.STREAM_SAMPLE * 1000 + j)
    pick = set(rng.choice(kept_idx, size=min(n, len(kept_idx)),
                          replace=False).tolist())
    offsets = [abs(len(qs[i]) - n_ref) for i in kept_idx]
    pick.add(int(kept_idx[int(np.argmax(offsets))]))
    return sorted(pick)


def check(st, jobs) -> dict:
    run = st.run
    qc_wrong = 0
    queries, rows = [], []
    for j, job in enumerate(jobs):
        if job["rc"] != 0:
            continue
        _, names, qs, kept = st.batches[job["facts"]["batch"]]
        kept_idx = np.nonzero(kept)[0]
        sample = _sample(run, j, qs, kept_idx, len(st.ref))
        if run.control:
            got = {}
        else:
            recs = outputs.fasta_records(job["facts"]["prefix"] + ".aln.xz")
            emitted = [nm for nm, _ in recs]
            expect = [names[i] for i in kept_idx]
            qc_wrong += sum(a != b for a, b in zip(emitted, expect))
            qc_wrong += abs(len(emitted) - len(expect))
            got = dict(recs)
        for i in sample:
            queries.append(qs[i])
            rows.append(got.get(names[i], b""))
    if run.control:
        rows = ref.control_rows(st.ref, queries, run.device)
    verdicts = ref.judge(st.ref, queries, rows, run.device)
    not_optimal = sum(own is None or own != opt for opt, own in verdicts)
    return {"qc_wrong": (qc_wrong, 0), "rows_not_optimal": (not_optimal, 0)}
