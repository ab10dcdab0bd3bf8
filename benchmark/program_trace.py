"""The program's own trace, read in this process (the drivers call the
program's ``cli.main`` here): the job records of
``uvaia_tpu_torch.utils.observe.jobs()``, each matched to the harness's
job record inside whose ``[t0_ns, t1_ns]`` its root span starts (both
on ``time.perf_counter_ns``, the clock of the device trace).  A program
that keeps no such records (one older than its tracer) reads None."""

from __future__ import annotations

import bisect


def matched(harness_jobs: list[dict]):
    """[(harness job, program job)] for every job given, or None if the
    program keeps no records or one of the jobs has none."""
    from uvaia_tpu_torch.utils import observe
    records = getattr(observe, "jobs", None)
    if records is None or not harness_jobs:
        return None
    program = records()
    out = []
    for h in harness_jobs:
        hits = [p for p in program if h["t0_ns"] <= p.root.t0 <= h["t1_ns"]]
        if not hits:
            return None
        out.append((h, hits[-1]))
    return out


def span_ns(job, names) -> int:
    """The summed time of the job's spans named in `names`: a device
    span's stream time, else its self time (its length less that of
    its children on its own thread)."""
    device: dict[str, int] = {}
    for s in job.spans:
        if s.name in names and s.device_ns is not None:
            device[s.name] = device.get(s.name, 0) + s.device_ns
    own = job.self_ns()
    return sum(device[n] if n in device else own.get(n, 0) for n in names)


def uncovered_ns(gaps, job) -> tuple[int, int]:
    """(idle, unattributed): the length of `gaps` ((t0, t1) intervals)
    and the part of it in which the job's main thread (its root's) is
    inside no span below the root."""
    spans = sorted((s.t0, s.t1) for s in job.spans
                   if s.thread == job.root.thread)
    merged: list[list[int]] = []
    for t0, t1 in spans:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    starts = [m[0] for m in merged]
    idle = unattributed = 0
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        idle += g1 - g0
        inside = 0
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        while k < len(merged) and merged[k][0] < g1:
            inside += max(0, min(g1, merged[k][1]) - max(g0, merged[k][0]))
            k += 1
        unattributed += g1 - g0 - inside
    return idle, unattributed
