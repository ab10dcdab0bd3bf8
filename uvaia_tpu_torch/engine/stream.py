"""Host-side streaming for the port's scans.

``RefStreamer``, ``dump_entry`` and ``write_dump`` are
``uvaia_tpu.engine.stream``'s (numpy and native IO, no jax);
:class:`EncodedStream` is the counterpart of its encode stage, encoding
with the port's jax-free host module (ops/host.py).
"""

from __future__ import annotations

import os

import numpy as np

from uvaia_tpu.engine.stream import RefStreamer, dump_entry, write_dump
from uvaia_tpu.utils.prefetch import Prefetcher, ordered_pool_map

from ..ops import host

__all__ = ["EncodedStream", "RefStreamer", "dump_entry", "write_dump"]


class EncodedStream:
    """Host-encode batches on a worker pool, yielding (batch, payload)
    in order: ("delta", pos, val) when the sparse diff fits the
    buckets, else ("packed", packed).  Batches i+1..i+workers encode
    while batch i's upload and device step run.  ``workers``
    (UVAIA_TPU_ENCODE_THREADS) defaults to min(2, cpu_count - 1),
    floor 1, as in the JAX package."""

    def __init__(self, streamer: RefStreamer, delta_base: np.ndarray,
                 prefetch: int = 2, workers: int | None = None):
        self.streamer = streamer
        self.delta_base = delta_base
        if workers is None:
            workers = int(os.environ.get(
                "UVAIA_TPU_ENCODE_THREADS",
                max(1, min(2, (os.cpu_count() or 1) - 1))))
        self._workers = max(1, workers)
        self._pf = Prefetcher(self._batches,
                              maxsize=max(prefetch, self._workers))

    def _encode(self, batch):
        enc = host.delta_encode(batch.codes, batch.ok, self.delta_base)
        if enc is not None:
            return batch, ("delta", enc[0], enc[1])
        return batch, ("packed", host.pack_codes(batch.codes))

    def _batches(self):
        yield from ordered_pool_map(self._encode, self.streamer,
                                    self._workers)

    def __iter__(self):
        return iter(self._pf)
