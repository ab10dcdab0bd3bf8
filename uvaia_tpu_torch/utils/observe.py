"""Tracing of the port's jobs, and the operator's profiler switch.

One tracer records what a job (one ``nearest`` or ``align`` run) did:

* ``job(tool, log)`` opens the job's root span.  Every span opened
  while it is open, on any thread (the reader and prefetch threads
  too), carries the job's id: the job is process-wide, not
  thread-local, because a job's threads are its own.
* ``span(name)`` is a context manager and a decorator.  It records its
  name, its parent (the innermost span open on the same thread, else
  the root), the job, the thread, and its start and end on
  ``time.perf_counter_ns``.  ``span(name, device=d)``, for a CUDA
  device ``d`` (``True``: the current one), also records CUDA events on
  that device's current stream at entry and exit, which never block
  the host; they are resolved when the job closes, after the job's own
  last host read, into the time the span held the stream.
* ``iter_spans(name, iterable)`` spans each ``next`` of an iterator
  (the time a consumer waits, or a producer thread works, per item).
* ``count(name, n)`` adds to one of the job's counters; the engines
  add once per batch or group, never once per row.  The root span's
  ``counts`` are the job's counters, which the engines' log lines
  print.
* ``jobs()`` returns the records of the last ``RING`` jobs.  At each
  job's end one line goes to ``log``: ``Trace: <tool> <wall> s;
  <span>=<s> ...; <counter>=<n> ...`` (the self time of each span
  name, then the counts).

A span times itself, and a job counts, whether or not it records, so
the engines take the times and counts of their log lines from the
tracer.  ``UVAIA_TPU_TRACE=0`` records no span and no job and prints
no ``Trace:`` line.  While a
``torch.profiler`` is active each span also opens a
``record_function`` range of its name, so a profile shows the
program's phases on the timeline of its kernels.

Set ``UVAIA_TPU_PROFILE=<dir>`` (the JAX package's variable) to record
such a ``torch.profiler`` trace of a run, written as
``<dir>/trace.json`` (Chrome / Perfetto format) with a per-kernel
summary on stderr.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import sys
import threading
import time
from dataclasses import dataclass, field

RING = 256


def _profiler():
    """torch's autograd profiler module while a profile is recording
    (this module imports no torch: the store's readers use it)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


@dataclass
class SpanRecord:
    name: str
    id: int
    parent: int | None           # None for a job's root
    job: int
    thread: int                  # threading.get_ident()
    t0: int = 0                  # perf_counter_ns
    t1: int = 0
    device_ns: int | None = None  # stream time of a device span


@dataclass
class JobRecord:
    id: int
    tool: str
    root: SpanRecord
    spans: list = field(default_factory=list)   # below the root
    counts: dict = field(default_factory=dict)
    events: list = field(default_factory=list)  # (record, ev0, ev1)
    recording: bool = True       # False: counts only (UVAIA_TPU_TRACE=0)

    def self_ns(self) -> dict[str, int]:
        """Self time of each span name below the root (its duration
        less its children's on the same thread), in order of start."""
        by_id = {s.id: s for s in self.spans}
        by_id[self.root.id] = self.root
        covered: dict[int, int] = collections.Counter()
        for s in self.spans:
            p = by_id.get(s.parent)
            if p is not None and p.thread == s.thread:
                covered[p.id] += s.t1 - s.t0
        out: dict[str, int] = {}
        for s in sorted(self.spans, key=lambda s: s.t0):
            out[s.name] = out.get(s.name, 0) + s.t1 - s.t0 - covered[s.id]
        return out

    def line(self) -> str:
        spans = [f"{k}={v / 1e9:.3f}" for k, v in self.self_ns().items()]
        counts = [f"{k}={v}" for k, v in self.counts.items()]
        wall = (self.root.t1 - self.root.t0) / 1e9
        return (f"Trace: {self.tool} {wall:.3f} s; {' '.join(spans)}; "
                f"{' '.join(counts)}")


class Span:
    """One span; see the module docstring.  ``seconds()`` is its length
    so far (recording or not)."""

    def __init__(self, tracer: "Tracer", name: str, device=False):
        self._tracer = tracer
        self.name = name
        self.device = device   # False, True (the current device) or a device
        self.t0 = self.t1 = 0
        self._rec = self._job = self._ev0 = self._stream = None
        self._range = None

    def seconds(self) -> float:
        return ((self.t1 or time.perf_counter_ns()) - self.t0) / 1e9

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with Span(self._tracer, self.name, self.device):
                return fn(*a, **kw)
        return wrapper

    def _open(self, job: JobRecord, parent: int | None) -> None:
        tr = self._tracer
        self._job = job
        self._rec = SpanRecord(self.name, next(tr._ids), parent, job.id,
                               threading.get_ident())
        tr._stack().append(self._rec)
        if self.device is not False:
            import torch
            dev = None if self.device is True else torch.device(self.device)
            if (dev.type == "cuda" if dev is not None
                    else torch.cuda.is_available()):
                self._stream = torch.cuda.current_stream(dev)
                self._ev0 = torch.cuda.Event(enable_timing=True)
                self._ev0.record(self._stream)

    def _open_range(self) -> None:
        prof = _profiler()
        if prof is not None:
            self._range = prof.record_function(self.name)
            self._range.__enter__()

    def __enter__(self):
        self._open_range()
        job = self._tracer.current
        if job is not None and job.recording:
            stack = self._tracer._stack()
            self._open(job, stack[-1].id if stack else job.root.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        rec = self._rec
        if rec is not None:
            rec.t0, rec.t1 = self.t0, self.t1
            if self._ev0 is not None:
                ev1 = type(self._ev0)(enable_timing=True)
                ev1.record(self._stream)
                self._job.events.append((rec, self._ev0, ev1))
            self._tracer._stack().pop()
            if rec.parent is not None:
                self._job.spans.append(rec)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _JobSpan(Span):
    """A job's root span: opens the job, and closes it into the ring.
    Inside another job it is a plain span of that job."""

    def __init__(self, tracer, tool, log):
        super().__init__(tracer, tool)
        self._log = log
        self._own = None                  # the job this span opened

    @property
    def counts(self) -> dict:
        """The job's counters (the enclosing job's, if nested)."""
        return (self._own or self._job).counts

    def __enter__(self):
        tr = self._tracer
        if tr.current is not None:
            self._job = tr.current        # nested: a plain span
            return super().__enter__()
        self._open_range()
        job = self._own = JobRecord(
            next(tr._ids), self.name, None,
            recording=os.environ.get("UVAIA_TPU_TRACE", "1") != "0")
        tr.current = job
        if job.recording:
            self._open(job, None)
            job.root = self._rec
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        job = self._own
        if job is None:
            return False
        tr = self._tracer
        tr.current = None
        if not job.recording:
            return False
        for rec, ev0, ev1 in job.events:
            ev1.synchronize()             # done: the job has read it all
            rec.device_ns = int(ev0.elapsed_time(ev1) * 1e6)
        job.events = []
        tr.ring.append(job)
        if self._log is not None:
            self._log(job.line())
        return False


class Tracer:
    """Records of the jobs of one process (the module's functions use
    the one ``TRACER``)."""

    def __init__(self, ring: int = RING):
        self.ring: collections.deque = collections.deque(maxlen=ring)
        self.current: JobRecord | None = None
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def job(self, tool: str, log=None) -> Span:
        return _JobSpan(self, tool, log)

    def span(self, name: str, device=False) -> Span:
        return Span(self, name, device)

    def iter_spans(self, name: str, iterable):
        it = iter(iterable)
        try:
            while True:
                with Span(self, name):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item
        finally:
            if hasattr(it, "close"):
                it.close()

    def count(self, name: str, n: int = 1) -> None:
        job = self.current
        if job is not None:
            with self._lock:
                job.counts[name] = job.counts.get(name, 0) + int(n)

    def jobs(self) -> list[JobRecord]:
        return list(self.ring)


TRACER = Tracer()
job = TRACER.job
span = TRACER.span
iter_spans = TRACER.iter_spans
count = TRACER.count
jobs = TRACER.jobs


@contextlib.contextmanager
def maybe_profile():
    """The operator's switch: a ``torch.profiler`` trace of the block
    when ``UVAIA_TPU_PROFILE`` names a directory (the spans opened in it
    are ranges of the trace), else nothing."""
    outdir = os.environ.get("UVAIA_TPU_PROFILE")
    if not outdir:
        yield
        return
    import torch
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
