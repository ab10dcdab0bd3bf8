"""The work of the banded Gotoh forward in `align` jobs, from the inputs
alone: each query that passes QC is one row of n x (2h + 1) cells, h the
smallest of 64, 128, 256 and 512 that covers |m - n| + 16 (the
program's routing rule at commit 0e5ecf2, frozen here); a row beyond
512 counts 2 (|m - n| + 16) + 1, over the profiled jobs.  Escalations and fallbacks count
nothing, so their time lowers the share."""

from benchmark.roofline.peaks import bound_s as _bound, gotoh_forward_work

LEVELS = (64, 128, 256, 512)
MARGIN = 16


def band_width(n: int, m: int) -> int:
    d = abs(m - n) + MARGIN
    return 2 * next((h for h in LEVELS if d <= h), d) + 1


def bound_s(run, launches):
    n = run.config["length"]
    widths, qbytes = [], 0
    for job in run.traced_jobs:
        for m in job["facts"]["passed_lengths"]:
            widths.append(band_width(n, m))
            qbytes += m
    if not widths:
        return None
    w = gotoh_forward_work(n, widths, qbytes)
    return _bound(w["nbytes"], int32_ops=w["int32_ops"])
