"""A kernel's share of its roofline: the least time the card could take
for the work the cell's inputs need (benchmark/roofline/<work>.py, from
the inputs and the program's counts, never from what the kernel reads)
over the kernel's device time in the traced window (the events whose
name holds every substring of one of spec['kernels'])."""

from benchmark.harness import BENCH, load_module


def read(run, spec):
    tr = run.trace_data
    if tr is None:
        return None
    secs, launches = tr.kernels(spec["kernels"])
    if not launches or secs <= 0:
        return None
    work = load_module(BENCH / "roofline" / f"{spec['work']}.py")
    bound = work.bound_s(run, launches)
    if not bound:
        return None
    return 100.0 * bound / secs
