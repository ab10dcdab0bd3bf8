"""The benchmark harness of uvaia_tpu_torch: one cell, one run, one line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything of one cell is data found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``file``) and its traffic
mix (``benchmark/traffic/<traffic>.json``); ``benchmark/workloads/
<cell>.json`` names the job driver (``benchmark/drivers/<driver>.py``)
and the size of the check; each metric is ``benchmark/metrics/
<metric>.json``, naming its reader (``benchmark/readers/<reader>.py``)
and, for a roofline share, the work it is held to
(``benchmark/roofline/<work>.py``); the traced run wraps the program
functions listed in ``benchmark/spans/<layer>.json`` from outside.

A run: set up (imports, the kernel library, the cell's data from the
seed, a warm-up job; all of it ``setup_s``), run whole jobs one after
another until ``--seconds`` have passed, read the peak device memory,
check the jobs' outputs against the plain reference in
``benchmark/reference/``, and print the numbers compared (last lines of
standard error) and one JSON line (last line of standard output).

``--trace 1`` installs the spans for the whole run and, once the window
has closed, runs one more job under torch.profiler: the span shares
are read from the window's jobs, which no profiler slows, and the
device's numbers (busy and idle time, kernel rooflines, the breakdown)
from the profiled job.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "uvaia_tpu")
TAIL_CHARS = 1500


def log(msg: str) -> None:
    print(msg, file=sys.__stderr__, flush=True)


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """A benchmark file loaded as a module of its own (its name may hold
    dots and dashes)."""
    name = "benchmark_" + "_".join(path.relative_to(BENCH).with_suffix("")
                                   .parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def merge(base: dict, over: dict) -> dict:
    """`base` with `over`'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


class Cell:
    """One cell of BENCHMARK.json with its files."""

    def __init__(self, name: str, tiny: bool = False):
        spec = load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"unknown workload {name!r}; BENCHMARK.json has "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = load_json(ROOT / configs[self.entry["config"]]["file"])
        self.traffic = load_json(BENCH / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.workload = load_json(BENCH / "workloads" / f"{name}.json")
        if tiny:
            t = self.workload.get("tiny", {})
            self.config = merge(self.config, t.get("config", {}))
            self.traffic = merge(self.traffic, t.get("traffic", {}))
            self.workload = merge(self.workload, t.get("workload", {}))
        self.run_seconds = spec["run_seconds"]
        self.end_to_end = [m for m in spec["end_to_end"] if self._mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._mine(m)]

    def _mine(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def driver(self):
        return load_module(BENCH / "drivers"
                           / f"{self.workload['driver']}.py")

    @staticmethod
    def metric_spec(name: str) -> dict:
        return load_json(BENCH / "metrics" / f"{name}.json")


# ----------------------------------------------------------------------
# spans: program functions wrapped from outside (traced runs only)


class Spans:
    """Host intervals (perf_counter_ns) of wrapped program functions, and
    for a target marked ``"device": true`` the time the call held the
    device's stream: CUDA events recorded on the current stream at entry
    and exit, which never block the host.  The entry event completes once
    the work queued before the call has, so that time leaves it out."""

    def __init__(self):
        self.intervals: dict[str, list] = {}
        self.device: dict[str, list] = {}   # name -> [(t0_ns, ev0, ev1)]
        self.broken: set[str] = set()     # spans with a target not found
        self._undo: list = []
        self._lock = threading.Lock()

    def _add(self, name, t0, t1):
        with self._lock:
            self.intervals.setdefault(name, []).append((t0, t1))

    def device_ns(self, name: str, lo_ns: int, hi_ns: int) -> int | None:
        """Summed stream time of the device span's calls that started in
        [lo_ns, hi_ns] (after a synchronize); None for a host span."""
        if name not in self.device:
            return None
        return sum(int(e0.elapsed_time(e1) * 1e6)
                   for t0, e0, e1 in self.device[name] if lo_ns <= t0 <= hi_ns)

    @staticmethod
    def resolve(dotted: str):
        """(owner, attribute) of a dotted module path plus attributes."""
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            try:
                obj = importlib.import_module(".".join(parts[:cut]))
            except ImportError:
                continue
            for p in parts[cut:-1]:
                obj = getattr(obj, p)
            if not hasattr(obj, parts[-1]):
                raise AttributeError(dotted)
            return obj, parts[-1]
        raise ImportError(dotted)

    def install(self, files, names) -> None:
        """Wrap the targets of the spans in `names` found in `files`."""
        import torch
        for path in files:
            for name, targets in load_json(path).items():
                if name not in names:
                    continue
                for tg in targets:
                    try:
                        owner, attr = self.resolve(tg["target"])
                    except (ImportError, AttributeError):
                        self.broken.add(name)
                        log(f"span {name}: {tg['target']} not found; its "
                            "metrics read null")
                        continue
                    orig = owner.__dict__.get(attr, getattr(owner, attr))
                    wrap = self._wrap(name, getattr(owner, attr),
                                      tg.get("kind", "call"),
                                      bool(tg.get("device")), torch)
                    setattr(owner, attr, wrap)
                    self._undo.append((owner, attr, orig))

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    def _wrap(self, name, fn, kind, device, torch):
        clock = time.perf_counter_ns
        device = device and torch.cuda.is_available()

        if kind == "iter":
            def wrapper(*a, **kw):
                it = iter(fn(*a, **kw))

                def timed():
                    try:
                        while True:
                            t0 = clock()
                            try:
                                item = next(it)
                            except StopIteration:
                                self._add(name, t0, clock())
                                return
                            self._add(name, t0, clock())
                            yield item
                    finally:
                        if hasattr(it, "close"):
                            it.close()
                return timed()
        else:
            def wrapper(*a, **kw):
                t0 = clock()
                if device:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                try:
                    return fn(*a, **kw)
                finally:
                    t1 = clock()
                    if device:
                        e1 = torch.cuda.Event(enable_timing=True)
                        e1.record()
                        with self._lock:
                            self.device.setdefault(name, []).append(
                                (t0, e0, e1))
                    self._add(name, t0, t1)
        return functools.wraps(fn)(wrapper)


def union_ns(intervals) -> int:
    """Total length of the union of (t0, t1) intervals."""
    total, end = 0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


# ----------------------------------------------------------------------
# the device trace


class Trace:
    """Device activity of the traced window from torch.profiler, on the
    host's perf_counter_ns clock (calibrated by a marker kernel)."""

    def __init__(self, events, t0_ns, t1_ns):
        self.events = events              # [(name, start_ns, end_ns)]
        self.t0, self.t1 = t0_ns, t1_ns

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.events]) / 1e9

    def kernels(self, patterns) -> tuple[float, int]:
        """(seconds, launches) of the events whose name holds every
        substring of some pattern (a list of substrings)."""
        secs, count = 0.0, 0
        for name, s, e in self.events:
            if any(all(p in name for p in pat) for pat in patterns):
                secs += (e - s) / 1e9
                count += 1
        return secs, count

    def top_ops(self, n: int = 10):
        by: dict[str, float] = {}
        for name, s, e in self.events:
            key = name[:120]
            by[key] = by.get(key, 0.0) + (e - s) / 1e9
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def gaps(self):
        """Idle intervals of the window, longest first."""
        ivs = sorted((max(s, self.t0), min(e, self.t1))
                     for _, s, e in self.events if e > self.t0 and s < self.t1)
        out, cur = [], self.t0
        for s, e in ivs:
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if self.t1 > cur:
            out.append((cur, self.t1))
        return sorted(out, key=lambda g: g[0] - g[1])


@contextlib.contextmanager
def device_trace(holder: dict):
    """Profile the CUDA activity of the block; holder['trace'] gets a
    Trace on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        mark = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        yield
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    cuda = torch.autograd.DeviceType.CUDA
    raw = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        s = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
        raw.append((ev.name(), s, s + ev.duration_ns()))
    raw.sort(key=lambda r: r[1])
    offset = (raw[0][1] - mark) if raw else 0
    events = [(n, s - offset, e - offset) for n, s, e in raw[1:]]
    holder["trace"] = Trace(events, t0, t1)


# ----------------------------------------------------------------------
# the run


class Run:
    """What the drivers, readers and checks share."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, control: bool, workdir: Path):
        self.cell = cell
        self.config, self.traffic = cell.config, cell.traffic
        self.workload = cell.workload
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.control = device, control
        self.work = workdir
        self.jobs: list[dict] = []
        self.spans = Spans()
        self.trace_data: Trace | None = None
        self.setup_s = 0.0
        self.window = (0, 0)
        self.host: dict = {}       # the host's load and speed (stderr)

    @property
    def window_jobs(self) -> list[dict]:
        """The jobs of the measured window (no profiler on)."""
        return [j for j in self.jobs if not j.get("profiled")]

    @property
    def traced_jobs(self) -> list[dict]:
        """The jobs run under the profiler, after the window."""
        return [j for j in self.jobs if j.get("profiled")]

    @contextlib.contextmanager
    def captured(self, rec: dict):
        """The program's standard error and output into rec['log']."""
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf), contextlib.redirect_stdout(buf):
            try:
                yield
            finally:
                rec["log"] = buf.getvalue()

    @contextlib.contextmanager
    def phase(self, name: str):
        """Log the seconds a step of set-up or of the check takes."""
        t0 = time.perf_counter()
        yield
        log(f"{name}: {time.perf_counter() - t0:.3f} s")

    def job(self, fn, *a, **kw) -> dict:
        """A timed program call: rec with t0, t1 (perf_counter s), t0_ns,
        t1_ns, rc and log."""
        c0 = cpu_s()
        t0 = time.perf_counter_ns()
        rec = self.call_program(fn, *a, **kw)
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        rec.update(t0=t0 / 1e9, t1=t1 / 1e9, t0_ns=t0, t1_ns=t1,
                   cpu_s=cpu_s() - c0)
        log(f"job {len(self.jobs)}: {(t1 - t0) / 1e9:.3f} s, "
            f"cpu {rec['cpu_s']:.3f} s, rc {rec['rc']}")
        return rec

    def call_program(self, fn, *a, **kw) -> dict:
        """rec with 'rc' and 'log' of fn(*a) (exceptions are rc -1)."""
        rec: dict = {}
        with self.captured(rec):
            try:
                rc = fn(*a, **kw)
                rec["rc"] = rc if isinstance(rc, int) else 0
            except SystemExit as e:
                rec["rc"] = e.code if isinstance(e.code, int) else 1
                print(f"SystemExit: {e.code}")
            except Exception:
                import traceback
                traceback.print_exc()
                rec["rc"] = -1
        if rec["rc"] != 0:
            log(f"program call failed (rc {rec['rc']}); its log ends:\n"
                + rec["log"][-TAIL_CHARS:])
        return rec


def cpu_s() -> float:
    """CPU seconds of this process, all threads."""
    t = os.times()
    return t[0] + t[1]


def host_probe(threads: int = 8) -> dict:
    """The host's speed now, on the kind of work the jobs' host side
    does: the same 1 MiB of genome letters xz-compressed once on one
    thread and `threads` times on as many threads (MB/s).  Read beside a
    run's job times, it tells a slower host from slower program work."""
    import lzma
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    rng = np.random.default_rng(0)
    base = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 1 << 14)]
    data = np.tile(base, 64)
    data[rng.integers(0, data.size, 4096)] = ord("N")
    chunk = data.tobytes()
    t0 = time.perf_counter()
    lzma.compress(chunk)
    t1 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lzma.compress, [chunk] * threads))
    t2 = time.perf_counter()
    mb = len(chunk) / 1e6
    return {"xz_1_thread_mb_s": mb / (t1 - t0),
            f"xz_{threads}_threads_mb_s": threads * mb / (t2 - t1)}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> dict:
    import torch
    out = {"name": torch.cuda.get_device_name(0)}
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        out["nvidia_smi"] = r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["nvidia_smi"] = "not read"
    return out


def label_gaps(run: Run, trace: Trace, n: int = 10):
    """The longest idle gaps, each named by the span (or job phase) the
    host was in at its middle."""
    ivs = [(t0, t1, name) for name, lst in run.spans.intervals.items()
           for t0, t1 in lst]
    out = []
    for g0, g1 in trace.gaps()[:n]:
        mid = (g0 + g1) // 2
        inside = [(t1 - t0, name) for t0, t1, name in ivs if t0 <= mid <= t1]
        if inside:
            label = min(inside)[1]
        elif any(j["t0_ns"] <= mid <= j["t1_ns"] for j in run.jobs):
            label = "job, outside every span"
        else:
            label = "between jobs"
        out.append([label, (g1 - g0) / 1e9])
    return out


def read_metrics(run: Run, metrics: list[dict]) -> dict:
    out = {}
    for m in metrics:
        spec = Cell.metric_spec(m["name"])
        reader = load_module(BENCH / "readers" / f"{spec['reader']}.py")
        try:
            value = reader.read(run, spec)
        except Exception as e:                  # a reader never ends a run
            log(f"metric {m['name']}: reader failed: {e!r}")
            value = None
        if value is None:
            log(f"metric {m['name']}: nothing to read; left out")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for tests and the correctness control, never used by the check:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the port's plain versions, for tests")
    ap.add_argument("--tiny", action="store_true",
                    help="the workload file's tiny sizes, for tests")
    ap.add_argument("--control", action="store_true",
                    help="the reference's control in the program's place")
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    try:
        cell = Cell(args.workload, tiny=args.tiny)
    except KeyError as e:
        log(str(e.args[0]))
        return 2
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device (torch.cuda.is_available() is False)")
            return 1
        if torch.cuda.device_count() < cell.chips:
            log(f"{args.workload} needs {cell.chips} GPUs, "
                f"{torch.cuda.device_count()} visible")
            return 1
    workdir = ROOT / "build" / "benchmark_runs" / args.workload
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    run = Run(cell, args.seed, args.seconds, bool(args.trace), args.device,
              args.control, workdir)
    try:
        return _main(run, cell, t_start)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _main(run: Run, cell: Cell, t_start: float) -> int:
    import torch
    cuda = run.device == "cuda"
    if cuda:
        info = card()
        log(f"card: {info['nvidia_smi']}")
    driver = cell.driver()
    with run.phase("set-up of the cell"):
        state = driver.setup(run)
    if state is None:
        log("set-up failed")
        return 1
    if cuda:
        torch.cuda.synchronize()
    if run.trace:
        wanted = {s for m in cell.per_layer
                  for s in Cell.metric_spec(m["name"]).get("spans", ())}
        run.spans.install(sorted((BENCH / "spans").glob("*.json")), wanted)
    holder: dict = {}
    try:
        t_w0 = time.perf_counter()
        run.setup_s = t_w0 - t_start
        c0 = cpu_s()
        while True:
            rec = driver.run_job(state, len(run.jobs))
            run.jobs.append(rec)
            if run.control:
                # the control answers for as many jobs as a run has
                if len(run.jobs) >= cell.workload["check"]["control_jobs"]:
                    break
            elif time.perf_counter() - t_w0 >= run.seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        run.window = (t_w0, time.perf_counter())
        run.host = {"process_cores": (cpu_s() - c0)
                    / (run.window[1] - run.window[0])}
        if not run.control:
            run.host.update(host_probe())
        if run.trace and not run.control:
            tracing = device_trace(holder) if cuda \
                else contextlib.nullcontext()
            with tracing:
                rec = driver.run_job(state, len(run.jobs))
                rec["profiled"] = True
                run.jobs.append(rec)
    finally:
        run.spans.uninstall()
    run.trace_data = holder.get("trace")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_window = len(run.window_jobs)
    log(f"window: {n_window} jobs in "
        f"{run.window[1] - run.window[0]:.3f} s; set-up {run.setup_s:.3f} s")
    log("host over the window: " + ", ".join(
        f"{k} {v}" for k, v in run.host.items()))
    for j in run.traced_jobs if n_window else ():
        mean = sum(w["t1"] - w["t0"] for w in run.window_jobs) / n_window
        log(f"profiled job: {j['t1'] - j['t0']:.3f} s against the window "
            f"jobs' mean {mean:.3f} s")

    metrics = {} if run.control else read_metrics(
        run, cell.per_layer if run.trace else cell.end_to_end)
    try:
        with run.phase("check"):
            checks = driver.check(state, run.jobs)
    except Exception:                 # outputs the check cannot read
        import traceback
        log(traceback.format_exc()[-TAIL_CHARS:])
        checks = {"outputs_unreadable": (1, 0)}
    failed = sum(1 for j in run.jobs if j["rc"] != 0)
    checks["jobs_failed"] = (failed, 0)
    correct = bool(run.jobs) and all(v <= lim for v, lim in checks.values())

    found = forbidden_modules()
    if found:
        log(f"modules that must not load are loaded: {found}")
        return 1
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips if cuda else 0,
              "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(run.jobs),
              "failed": failed, "metrics": metrics, "device": device}
    if run.trace:
        tr = run.trace_data
        device["busy_s"] = tr.busy_s() if tr else 0.0
        device["window_s"] = tr.window_s if tr else (run.window[1]
                                                       - run.window[0])
        if tr:
            result["breakdown"] = {
                "device_ops": [[k, v] for k, v in tr.top_ops()],
                "idle_gaps": label_gaps(run, tr)}
    if cuda:
        result["card"] = info["nvidia_smi"]
    result["host"] = run.host
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    print(json.dumps(result), flush=True)
    return 0
