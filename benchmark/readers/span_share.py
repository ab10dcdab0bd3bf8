"""Percent of the window's job time spent inside the spans named in
spec['spans']: the union of their host intervals, or for a device span
(a target marked ``"device": true``) the summed time its calls held the
device's stream.  The window's jobs alone: a traced run's profiled job
comes after the window, so the profiler slows none of what is read."""

from benchmark.harness import union_ns


def read(run, spec):
    if any(name in run.spans.broken or name not in run.spans.intervals
           for name in spec["spans"]):
        return None
    jobs = run.window_jobs
    if not jobs:
        return None
    lo, hi = jobs[0]["t0_ns"], jobs[-1]["t1_ns"]
    total = 0
    host = []
    for name in spec["spans"]:
        dev = run.spans.device_ns(name, lo, hi)
        if dev is None:
            host += [iv for iv in run.spans.intervals[name]
                     if lo <= iv[0] <= hi]
        else:
            total += dev
    total += union_ns(host)
    wall = sum(j["t1_ns"] - j["t0_ns"] for j in jobs)
    return 100.0 * total / wall if wall else None
