"""Percent of the window's job time spent in the program's own spans
named in spec['program_spans'] (utils/observe.py): each span's self
time, or for a device span the time it held the device's stream,
summed over the window's jobs, over the jobs' wall time.  None if the
program records no spans or a window job has no record."""

from benchmark import program_trace


def read(run, spec):
    pairs = program_trace.matched(run.window_jobs)
    if not pairs:
        return None
    names = set(spec["program_spans"])
    total = sum(program_trace.span_ns(p, names) for _, p in pairs)
    wall = sum(h["t1_ns"] - h["t0_ns"] for h, _ in pairs)
    return 100.0 * total / wall if wall else None
