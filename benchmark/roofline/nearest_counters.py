"""The work of the full-mode counter kernels (score_counters and its
packed twin) in `nearest` jobs with the prune on: every row that
survives the prune is scored once against every query over every site,
over the profiled jobs.
Rows scored come from the engine's own count ("Prefilter skipped the
exact scan for X of Y references"), queries from the cell's inputs."""

import re

from benchmark.roofline.peaks import bound_s as _bound, counter_work

PRUNE = re.compile(r"Prefilter skipped the exact scan for (\d+) of (\d+)")


def bound_s(run, launches):
    rows = 0
    for job in run.traced_jobs:
        for m in PRUNE.finditer(job.get("log", "")):
            rows += int(m.group(2)) - int(m.group(1))
    jobs = run.traced_jobs
    queries = jobs[0]["facts"]["queries"] if jobs else 0
    if not rows or not queries:
        return None
    w = counter_work(rows, queries, run.config["length"], launches)
    return _bound(w["nbytes"], int8_ops=w["int8_ops"])
