"""Single-producer/single-consumer prefetch thread: the port's copy of
``uvaia_tpu/utils/prefetch.py``.

One shared implementation of the pipeline shape the reference gets from
its read-batch -> compute loops (nearest.c:249-319, align.c:183-252): a
daemon reader thread fills a bounded queue while the consumer computes.
Three engine sites (RefStreamer, EncodedStream, run_align's pool
reader) previously each hand-rolled this with diverging error/abort
semantics; this class makes them uniform:

* a producer exception is re-raised on the consumer side after the
  queued items drain (so everything read before the fault is used);
* when the consumer stops early (exception, break, or generator
  close), the producer is aborted via an Event, so it can never block
  forever on the bounded queue — every put is abortable.
"""

from __future__ import annotations

import queue
import threading


class Prefetcher:
    """Iterate ``produce()``'s items, generated on a background thread.

    ``produce`` is a zero-arg callable returning an iterator.  It may
    consult :meth:`aborted` between expensive steps for a prompt stop,
    but correctness never requires it — the queue put itself aborts.
    Single-consumer: iterate at most once.
    """

    def __init__(self, produce, maxsize: int = 2):
        self._produce = produce
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._err: BaseException | None = None
        self._abort = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def aborted(self) -> bool:
        return self._abort.is_set()

    def abort(self) -> None:
        self._abort.set()

    def _put(self, item) -> bool:
        while not self._abort.is_set():
            try:
                self._q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        it = None
        try:
            it = iter(self._produce())
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:   # surfaced on the consumer side
            self._err = e
        finally:
            # deterministically close the producer generator so chained
            # prefetchers (EncodedStream over RefStreamer) propagate the
            # abort upstream without waiting on GC
            if hasattr(it, "close"):
                try:
                    it.close()
                except BaseException as e:
                    if self._err is None:
                        self._err = e
            self._put(None)

    def __iter__(self):
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is None:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            # consumer stopped (normal end, exception, or close): the
            # producer must never stay blocked on the bounded queue
            self._abort.set()


def ordered_pool_map(fn, iterable, workers: int):
    """Map ``fn`` over ``iterable`` on a ``workers``-thread pool,
    yielding results IN INPUT ORDER while keeping up to ``workers``
    calls in flight (serial when workers <= 1).

    The shared submit-ahead/pop-in-order pipeline used by the engine's
    encode stage (engine/stream.EncodedStream) and by bench.py's
    streamed-delta measurement — one implementation so what the bench
    times IS the pipeline the engines run."""
    if workers <= 1:
        for item in iterable:
            yield fn(item)
        return
    import collections
    import concurrent.futures as cf
    with cf.ThreadPoolExecutor(workers) as ex:
        it = iter(iterable)
        futs: collections.deque = collections.deque()
        try:
            for _ in range(workers):
                futs.append(ex.submit(fn, next(it)))
        except StopIteration:
            it = None
        while futs:
            out = futs.popleft().result()
            if it is not None:
                try:
                    futs.append(ex.submit(fn, next(it)))
                except StopIteration:
                    it = None
            yield out
