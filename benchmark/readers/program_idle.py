"""Percent of the profiled job's device idle time (the trace's gaps,
clipped to the job) in which the job's main thread is inside none of
the program's spans below the job's root: how much of the idle time the
program's spans leave unexplained.  None without a device trace or a
program record of the profiled job."""

from benchmark import program_trace


def read(run, spec):
    tr = run.trace_data
    if tr is None:
        return None
    pairs = program_trace.matched(run.traced_jobs)
    if not pairs:
        return None
    idle = unattributed = 0
    for h, p in pairs:
        gaps = sorted((max(g0, h["t0_ns"]), min(g1, h["t1_ns"]))
                      for g0, g1 in tr.gaps())
        i, u = program_trace.uncovered_ns(gaps, p)
        idle += i
        unattributed += u
    return 100.0 * unattributed / idle if idle else None
