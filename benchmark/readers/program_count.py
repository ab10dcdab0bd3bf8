"""Percent from the program's own counters (utils/observe.py): the
counters in spec['numerator'] over those in spec['denominator'], each
summed over the window's jobs.  None if the program counts nothing, a
window job has no record, or the denominator is 0."""

from benchmark import program_trace


def read(run, spec):
    pairs = program_trace.matched(run.window_jobs)
    if not pairs:
        return None
    num = sum(p.counts.get(k, 0) for _, p in pairs for k in spec["numerator"])
    den = sum(p.counts.get(k, 0) for _, p in pairs
              for k in spec["denominator"])
    return 100.0 * num / den if den else None
