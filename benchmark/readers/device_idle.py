"""Percent of the traced window in which no kernel, copy or memset ran on
the device (torch.profiler's CUDA activity)."""


def read(run, spec):
    tr = run.trace_data
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
