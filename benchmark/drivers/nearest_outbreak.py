"""Job driver of `nearest` cells whose batches are outbreaks: every
query of prepared batch j is a genome of one lineage, the lineage of
Zipf rank j + 1 (the same lineage for every seed, so that runs of
different seeds do the same work).

Everything else is the `nearest` driver's (drivers/nearest.py, loaded
by name): the database from the seed and its form (``database`` in the
workload file), the warm-up job, ``_argv`` and the check against the
plain reference.  Set-up runs that driver's and then writes the
outbreak batches over its prepared query files.
"""

from __future__ import annotations

import copy

import numpy as np

from benchmark.harness import BENCH, load_module
from benchmark.reference import nearest as ref
from benchmark.traffic import genomes as gen

base = load_module(BENCH / "drivers" / "nearest.py")
run_job = base.run_job
check = base.check


def one_lineage(tree: gen.LineageTree, lineage: int) -> gen.LineageTree:
    """The tree with every genome drawn from `lineage` alone."""
    out = copy.copy(tree)
    out.weights = np.zeros_like(tree.weights)
    out.weights[lineage] = 1.0
    return out


def outbreak(run, tree: gen.LineageTree, j: int, n: int) -> np.ndarray:
    """(n, L) aligned genomes of prepared batch j: all of the lineage
    of Zipf rank j + 1 (lineage index j: the weights fall with the
    index)."""
    return gen.aligned_rows(gen.rng_for(run.seed, gen.STREAM_JOB0 + j),
                            one_lineage(tree, j), n, run.traffic)


def setup(run):
    st = base.setup(run)
    if st is None:
        return None
    c, mix = run.config, run.traffic
    tree = gen.LineageTree(run.seed, c["length"], c["composition"],
                           mix["lineages"])
    Q = mix["queries_per_job"]
    with run.phase("set-up: outbreak batches"):
        for j, (path, names, _, _) in enumerate(st.queries):
            q = outbreak(run, tree, j, Q)
            gen.write_fasta(path, names, q)
            st.queries[j] = (path, names, q,
                             ref.query_qc(ref.codes(q), c["query_ambiguity"]))
    return st
