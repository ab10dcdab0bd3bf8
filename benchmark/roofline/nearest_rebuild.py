"""The work of the sparse-delta rebuild (`delta_rebuild_kernel`) in
`nearest` jobs, from the profiled jobs' own upload counts and the
length, never from what the kernel reads: each delta slot's position
and value read once (3 bytes: uint16 and uint8), each delta row's L
sites written once, and the base's L bytes read once a launch.  No
operation term: the rebuild moves bytes."""

from benchmark import program_trace
from benchmark.roofline.peaks import bound_s as _bound


def rebuild_bytes(slots: int, rows: int, sites: int, launches: int) -> int:
    return 3 * slots + sites * rows + sites * launches


def bound_s(run, launches):
    pairs = program_trace.matched(run.traced_jobs)
    if not pairs:
        return None
    slots = sum(p.counts.get("delta_slots", 0) for _, p in pairs)
    rows = sum(p.counts.get("delta_rows", 0) for _, p in pairs)
    if not slots or not rows:
        return None
    return _bound(rebuild_bytes(slots, rows, run.config["length"],
                                launches))
