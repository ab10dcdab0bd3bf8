"""Percent of a worker pool's time spent in the program's spans named
in spec['program_spans'] (utils/observe.py): their self time, summed
over the window's jobs, over each job's wall time times its pool size,
the job's counter spec['workers'].  None if the program records no
spans, a window job has no record, or a job does not count its pool."""

from benchmark import program_trace


def read(run, spec):
    pairs = program_trace.matched(run.window_jobs)
    if not pairs:
        return None
    names = set(spec["program_spans"])
    busy = capacity = 0
    for h, p in pairs:
        workers = p.counts.get(spec["workers"], 0)
        if workers <= 0:
            return None
        busy += program_trace.span_ns(p, names)
        capacity += workers * (h["t1_ns"] - h["t0_ns"])
    return 100.0 * busy / capacity if capacity else None
