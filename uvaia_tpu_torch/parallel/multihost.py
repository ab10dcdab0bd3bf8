"""Multi-process database scan — the counterpart of
``uvaia_tpu/parallel/multihost.py``.

The database file list is split into *contiguous* per-process ranges
(keeping the command-line order, which is the tie-break order of the
first-seen-wins ranking) — or, when every input is an ingested store,
into contiguous per-process ROW ranges of the concatenated stores, so
one large store is shared without re-ingesting it.  Each process scans
its range with the local engine (one device, or a mesh through
cfg.n_devices); at the end the small per-query top-k states — (Q, k, 6)
scores plus names — are all-gathered across the processes and ranked
again, and process 0 writes the final CSV.  The gathered bytes are
O(processes * Q * k) whatever the database size; each process's
``.aln`` dump stays a valid superset of its own share.

The processes meet in a ``torch.distributed`` group on the ``gloo``
backend (host tensors over TCP): the gathered state is host data
already, gloo runs on machines without a GPU, and several processes may
share one card.  Process 0 listens at the coordinator address
``host:port``; a process that does not join within the group's timeout
fails the run.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from ..engine.nearest import (CSV_HEADER_ACGT, CSV_HEADER_FULL,
                              NearestConfig, run_nearest)
from ..engine.query import log
from ..io.compress import open_write
from ..ops.host import IDX_SENTINEL

NAME_W = 256          # minimum name-slot width for the cross-host gather
                      # (widened to the global max name length, so long
                      # FASTA headers are never truncated)
# how long a process waits for its peers, at the rendezvous and at the
# final gather (a peer that scans a larger share arrives later)
GROUP_TIMEOUT_S = 1800.0


def assign_files(paths: list[str], n_processes: int,
                 process_id: int) -> list[str]:
    """Contiguous per-host file ranges, balanced by compressed size.

    Contiguity in the given order keeps (host, local_index) ordering
    identical to the single-process global record order, preserving
    tie-break parity.
    """
    sizes = [max(os.path.getsize(p), 1) for p in paths]
    total = sum(sizes)
    bounds = [0]
    acc = 0
    nxt = 1
    for i, s in enumerate(sizes):
        acc += s
        while nxt < n_processes and acc * n_processes >= nxt * total:
            bounds.append(i + 1)
            nxt += 1
    while len(bounds) < n_processes:
        bounds.append(len(paths))
    bounds.append(len(paths))
    return paths[bounds[process_id]:bounds[process_id + 1]]


def _all_gather(x: np.ndarray) -> np.ndarray:
    """(P, ...) stack of every process's fixed-shape array x."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _gather_parts(scores: np.ndarray, idx: np.ndarray,
                  names: np.ndarray):
    """All-gather the fixed-shape per-host top-k state over the group.
    Returns (P, ...) stacked arrays."""
    return _all_gather(scores), _all_gather(idx), _all_gather(names)


def run_nearest_multihost(ref_paths: list[str], query_path: str,
                          cfg: NearestConfig, num_processes: int,
                          process_id: int,
                          coordinator: str | None = None):
    """Entry point for a multi-process scan.  Every process runs this
    with the same arguments except process_id; with num_processes > 1
    they meet at ``coordinator`` (host:port, where process 0 listens)."""
    if num_processes > 1 and not coordinator:
        raise SystemExit(
            f"--num-hosts {num_processes} needs --coordinator host:port "
            "(the address where process 0 listens; every process passes "
            "the same one)")
    if not 0 <= process_id < num_processes:
        raise SystemExit(f"--host-id {process_id} is outside "
                         f"[0, {num_processes})")
    if num_processes > 1:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        return _run(ref_paths, query_path, cfg, num_processes, process_id)
    finally:
        if num_processes > 1:
            dist.destroy_process_group()


def _run(ref_paths, query_path, cfg, num_processes, process_id):
    from ..io import store as store_mod
    range_kw = {}
    if num_processes > 1 and ref_paths and \
            all(store_mod.is_store(p) for p in ref_paths):
        # all-store inputs split by ROW ranges, not files: one big
        # ingested store shares across hosts without re-ingesting
        # per-host shards.  Ranges are contiguous in concatenated row
        # order, so (host, local_index) still equals the single-process
        # global order and the merge's first-seen tie-break is preserved.
        total = sum(store_mod.peek_store_rows(p) for p in ref_paths)
        lo = total * process_id // num_processes
        hi = total * (process_id + 1) // num_processes
        my_files = list(ref_paths)
        range_kw = dict(skip_records=lo, limit_records=hi)
        log(f"[host {process_id}/{num_processes}] scanning store rows "
            f"[{lo}, {hi}) of {total}")
    else:
        my_files = assign_files(ref_paths, num_processes, process_id)
        log(f"[host {process_id}/{num_processes}] scanning "
            f"{len(my_files)} of {len(ref_paths)} database files")
    # per-host output AND checkpoint paths: on a shared filesystem a
    # single checkpoint path would be overwritten by every host, and
    # resume would fail the config-key check on all but the last writer
    part_cfg = replace(
        cfg, output=f"{cfg.prefix}.h{process_id}",
        checkpoint=(f"{cfg.checkpoint}.h{process_id}"
                    if cfg.checkpoint else None), **range_kw)
    res = run_nearest(my_files, query_path, part_cfg)

    k = res.indices.shape[1]
    used = [res.names.get(int(ri), f"db_{int(ri)}").encode()
            for row in res.indices for ri in row
            if int(ri) != int(IDX_SENTINEL)]
    local_w = max([len(b) for b in used] or [1])
    if num_processes > 1:
        # agree on one slot width across hosts before the fixed-shape
        # gather (names must never truncate — the merged CSV joins
        # against the per-host outputs by name)
        widths = _all_gather(np.array([local_w], dtype=np.int32))
        name_w = max(NAME_W, int(widths.max()))
    else:
        name_w = max(NAME_W, local_w)
    names = np.zeros((res.indices.shape[0], k, name_w), dtype=np.uint8)
    for qi in range(res.indices.shape[0]):
        for slot in range(k):
            ri = int(res.indices[qi, slot])
            if ri == int(IDX_SENTINEL):
                continue
            b = res.names.get(ri, f"db_{ri}").encode()
            names[qi, slot, :len(b)] = np.frombuffer(b, dtype=np.uint8)

    if num_processes > 1:
        g_scores, g_idx, g_names = _gather_parts(
            res.scores.astype(np.int32), res.indices.astype(np.int32),
            names)
    else:
        g_scores, g_idx, g_names = (res.scores.astype(np.int32)[None],
                                    res.indices.astype(np.int32)[None],
                                    names[None])
    if process_id == 0:
        from ..io.fasta import WRITE_CODEC_SUFFIX
        out = cfg.prefix + ".csv" + WRITE_CODEC_SUFFIX[cfg.codec]
        n = merge_and_write(res.pack, g_scores, g_idx, g_names, out)
        log(f"[host 0] merged {g_scores.shape[0]} hosts -> {out} "
            f"({n} rows)")
    return res


def merge_and_write(pack, g_scores, g_idx, g_names, path: str) -> int:
    """Exact cross-host top-k merge + ranked CSV.

    Sort: lexicographically decreasing over the six scores, ties by
    ascending (host, local_index) == single-process first-seen order
    (host file ranges are contiguous).
    """
    P, Q, k, name_w = g_names.shape
    n_rows = 0
    with open_write(path) as fh:
        fh.write((CSV_HEADER_ACGT if pack.acgt
                  else CSV_HEADER_FULL).encode())
        for qi in range(Q):
            s = g_scores[:, qi].reshape(P * k, 6)
            li = g_idx[:, qi].reshape(P * k)
            host = np.repeat(np.arange(P), k).astype(np.int64)
            nm = g_names[:, qi].reshape(P * k, name_w)
            valid = li != int(IDX_SENTINEL)
            s, li, host, nm = s[valid], li[valid], host[valid], nm[valid]
            order = np.lexsort((li, host, -s[:, 5], -s[:, 4], -s[:, 3],
                                -s[:, 2], -s[:, 1], -s[:, 0]))
            for rank, ci in enumerate(order[:k], start=1):
                name = bytes(nm[ci][nm[ci] != 0]).decode(
                    "utf-8", errors="replace")
                row = ",".join([pack.names[qi], name, str(rank)]
                               + [str(int(x)) for x in s[ci]])
                fh.write((row + "\n").encode())
                n_rows += 1
    return n_rows
