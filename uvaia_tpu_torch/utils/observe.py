"""Wall-clock chronometer and optional device profiling for the port's
engine runs.  ``Chronometer`` is the JAX package's
(``uvaia_tpu/utils/observe.py``).

Set ``UVAIA_TPU_PROFILE=<dir>`` (the JAX package's variable) to record a
``torch.profiler`` trace of a run, written as ``<dir>/trace.json``
(Chrome / Perfetto format) with a per-kernel summary on stderr.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Chronometer:
    """Wall time since construction (the reference's time0)."""

    t0: float = field(default_factory=time.monotonic)

    def total(self) -> float:
        return time.monotonic() - self.t0


@contextlib.contextmanager
def maybe_profile():
    outdir = os.environ.get("UVAIA_TPU_PROFILE")
    if not outdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15), file=sys.stderr)
    print(f"uvaia_tpu_torch: profile written to {path}", file=sys.stderr)
