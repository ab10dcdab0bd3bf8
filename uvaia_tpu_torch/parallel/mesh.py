"""Sharded database scan over a (db, site) grid of devices — the
counterpart of ``uvaia_tpu/parallel/mesh.py``.

* ``db``   — data parallelism over database rows: each db shard scores
  its slice of the batch and takes its local per-query top-k; the
  candidates of every shard are gathered, in shard order, on the lead
  device and merged into the top-k state there.  Exact: every member of
  the global top-k is in its own shard's local top-k.
* ``site`` — the alignment columns split into equal blocks: each site
  shard runs the counter kernels on its block, and the site-summable
  partials (ops/scan.site_partials) are summed on the db row's first
  device.

One process drives every shard, as ``shard_map`` does in the JAX
package: a shard's work is launched on its own device, and the JAX
collectives become tensor moves (``all_gather`` over db: ``.to()`` the
lead device, then ``torch.cat``; ``psum`` over site: a sum on the db
row's first device).  Where shards share a device (the CPU, or one card
named n times) the moves are no-ops and the shards run one after
another.

Reference batches arrive as 4-bit packed rows or as sparse deltas, are
split over ``db`` and rebuilt on each db row's first device; the site
blocks are copied out of the full-width rows.  The ambiguity
corrections are taken after the site sum from full-width data: the
reference side from the whole rows, the query side from the whole
q_full, gathered once per db row.  (uvaia_tpu's TPU route,
``uvaia_tpu/ops/scan.py:377-388``, gathers the query side from the
shard's site block at the global column indices, which reads the wrong
columns when the site axis is sharded; its CPU route, through the
w_part/w_text tables, is right, and this module agrees with it.)
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops import scan
from ..ops.host import IDX_SENTINEL

_SENT = int(IDX_SENTINEL)


def local_devices(device_type: str, n: int) -> list[torch.device]:
    """The devices a mesh of n shards takes when it is given none: every
    visible CUDA device in order, or on the CPU the one CPU device n
    times (the counterpart of the JAX package's virtual CPU devices)."""
    if device_type == "cpu":
        return [torch.device("cpu")] * n
    if device_type != "cuda":
        raise ValueError(f"no mesh on device type {device_type!r}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(count)]


@dataclass(frozen=True)
class Mesh:
    """An (n_db, n_site) grid of devices: row i holds db shard i's site
    shards, and devices[0][0], the lead device, holds the top-k
    state."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"db": len(self.devices), "site": len(self.devices[0])}

    @property
    def lead(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(n_db: int, n_site: int = 1, devices=None,
              device_type: str = "cuda") -> Mesh:
    """An (n_db, n_site) mesh over ``devices``, by default
    local_devices(device_type, n_db * n_site)."""
    n = n_db * n_site
    if devices is None:
        devices = local_devices(device_type, n)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = [torch.device(d) for d in devices[:n]]
    return Mesh(tuple(tuple(dev[i * n_site:(i + 1) * n_site])
                      for i in range(n_db)))


def _on(dev: torch.device):
    """Launch on `dev` inside the block (the kernels launch on the
    current CUDA device)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@dataclass
class _SiteShard:
    dev: torch.device
    lo: int                      # site columns [lo, hi) of the padded width
    hi: int
    cons: torch.Tensor           # (w,) cons_full's block
    q: torch.Tensor              # (Q, w) q_full's block
    poly: torch.Tensor | None    # (Q, w) q_poly's block (--acgt)


@dataclass
class _DbShard:
    qd: scan.QueryDeviceData     # full width, on the row's first device
    q_amb: torch.Tensor | None   # (Q, A) q_full at qd.amb_sites
    sites: list

    @property
    def dev(self) -> torch.device:
        return self.qd.device


def _qd_to(qd: scan.QueryDeviceData, dev) -> scan.QueryDeviceData:
    return replace(qd, **{n: getattr(qd, n).to(dev) for n in scan._ARRAYS
                          if getattr(qd, n) is not None})


def _db_shards(qd: scan.QueryDeviceData, mesh: Mesh) -> list:
    """Each db row's query data, built once: the full-width tensors on
    the row's first device, and each site shard's contiguous block on
    its own device."""
    W, n_site = qd.width, mesh.shape["site"]
    if W % (1024 * n_site):
        raise ValueError(f"query data of width {W} does not split into "
                         f"{n_site} site blocks: build it with "
                         f"site_shards={n_site}")
    w = W // n_site

    def block(t, dev, lo):
        return t[..., lo:lo + w].contiguous().to(dev)

    rows = []
    for row in mesh.devices:
        rqd = _qd_to(qd, row[0])
        q_amb = None
        if rqd.amb_sites is not None:
            q_amb = scan._take_fill(rqd.q_full, rqd.amb_sites)
        sites = [_SiteShard(dev, j * w, (j + 1) * w,
                            block(qd.cons_full, dev, j * w),
                            block(qd.q_full, dev, j * w),
                            None if qd.q_poly is None
                            else block(qd.q_poly, dev, j * w))
                 for j, dev in enumerate(row)]
        rows.append(_DbShard(rqd, q_amb, sites))
    return rows


def _site_sum(qd: scan.QueryDeviceData, row: _DbShard, ref_codes):
    """(cons5, mats) of full-width rows on the row's first device: each
    site shard's counters over its block, summed over the site axis."""
    parts = []
    for sh in row.sites:
        with _on(sh.dev):
            blk = ref_codes[:, sh.lo:sh.hi].contiguous().to(sh.dev)
            parts.append(scan.site_partials(qd.acgt, sh.cons, sh.q, blk,
                                            sh.poly))
    cons5, mats = parts[0]
    for c, m in parts[1:]:
        cons5 = cons5 + c.to(row.dev)
        mats = tuple(a + b.to(row.dev) for a, b in zip(mats, m))
    return cons5, mats


def _scan_body(qd: scan.QueryDeviceData, rows: list, lead: torch.device):
    """body(state, codes, ok, ref_idx) -> (state, is_best): each db
    shard's full-width rows (codes[i] (b, W) on its row's device, with
    ok[i] and ref_idx[i]) scored, flagged against the step's incoming
    state and cut to a local top-k, then every shard's candidates
    merged into the state on the lead device.  Shared by the sharded
    step and the survivor flush."""
    k = qd.k

    def body(state, codes, ok, ref_idx):
        flags, cand_scores, cand_idx = [], [], []
        for row, rc, ok_r, idx_r in zip(rows, codes, ok, ref_idx):
            with _on(row.dev):
                cons5, mats = _site_sum(qd, row, rc)
                scores = scan.assemble_scores(row.qd, rc, cons5, mats,
                                              q_amb=row.q_amb)
                st = (state[0].to(row.dev), state[1].to(row.dev))
                is_best, batch_idx = scan.batch_flags_and_idx(
                    row.qd, st, scores.unbind(-1), ok_r, 0, ref_idx=idx_r)
                b = rc.shape[0]
                s, i = scan.select_topk(
                    row.qd, scores.transpose(0, 1),
                    batch_idx[None, :].expand(qd.n_query, b), min(k, b))
            flags.append(is_best)
            cand_scores.append(s)
            cand_idx.append(i)
        with _on(lead):
            all_scores = torch.cat(
                [state[0], *(s.to(lead) for s in cand_scores)], dim=1)
            all_idx = torch.cat([state[1], *(i.to(lead) for i in cand_idx)],
                                dim=1)
            new_state = scan.select_topk(qd, all_scores, all_idx, k)
            is_best = torch.cat([f.to(lead) for f in flags])
        return new_state, is_best

    return body


def _split(x: torch.Tensor, rows: list) -> list:
    """x's leading axis in len(rows) equal slices, each on its row's
    device."""
    n_db = len(rows)
    if x.shape[0] % n_db:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"over {n_db} db shards")
    b = x.shape[0] // n_db
    return [x[i * b:(i + 1) * b].to(row.dev) for i, row in enumerate(rows)]


def _rebuild(qd: scan.QueryDeviceData, rows: list, payload) -> list:
    """Each db shard's full-width (b, W) codes from its slice of the
    payload: 4-bit packed rows, or a (pos, val) sparse-delta pair
    rebuilt against the row's copy of qd.delta_base."""
    W = qd.width
    if isinstance(payload, tuple):
        pos, val = payload
        parts = zip(_split(pos, rows), _split(val, rows))
        out = []
        for row, (p, v) in zip(rows, parts):
            with _on(row.dev):
                out.append(scan.reconstruct_delta(row.qd.delta_base, p, v,
                                                  width=W))
        return out
    out = []
    for row, p in zip(rows, _split(payload, rows)):
        with _on(row.dev):
            out.append(scan._to_width(scan.unpack_codes(p, qd.n_sites), W))
    return out


def make_sharded_scan_step(qd: scan.QueryDeviceData, mesh: Mesh,
                           delta: bool = False):
    """(state, payload, ok, ref_idx) -> (state, is_best) over a
    (db, site) mesh.

    ``payload`` — the reference batch, split over db: by default a
                  (B, ceil(L/2)) uint8 4-bit packed matrix
                  (host.pack_codes); with ``delta=True`` the pos and val
                  of host.delta_encode as two arguments, rebuilt on each
                  db row against qd.delta_base.  B divisible by
                  mesh.shape['db'].
    ``ref_idx`` — (B,) int32 global database index of each row.
    The state and the (B,) flags live on mesh.lead; qd must be built
    with site_shards=mesh.shape['site'] (its tensors are copied to the
    shards here, once)."""
    rows = _db_shards(qd, mesh)
    body = _scan_body(qd, rows, mesh.lead)

    def run(state, payload, ok, ref_idx):
        return body(state, _rebuild(qd, rows, payload), _split(ok, rows),
                    _split(ref_idx, rows))

    if delta:
        def step(state, pos, val, ok, ref_idx):
            return run(state, (pos, val), ok, ref_idx)
    else:
        def step(state, packed, ok, ref_idx):
            return run(state, packed, ok, ref_idx)
    return step


def _prune(qd: scan.QueryDeviceData, rows: list, state, codes, ok):
    """Each db shard's phase-1 survivor mask, on its row's device."""
    out = []
    for row, rc, ok_r in zip(rows, codes, ok):
        with _on(row.dev):
            st = (state[0].to(row.dev), state[1].to(row.dev))
            out.append(scan.prune_step(row.qd, st, rc, ok_r))
    return out


def _require_prune_data(qd: scan.QueryDeviceData) -> None:
    if qd.u_base is None:
        raise ValueError("call scan.build_prune_data(qd, pack) first")


def make_sharded_prune_step(qd: scan.QueryDeviceData, mesh: Mesh,
                            delta: bool = False):
    """(state, payload, ok) -> survive (B,) bool on mesh.lead: the
    lossless phase-1 prefilter (scan.prune_step) data-parallel over db,
    with the prefilter tensors copied whole to each db row (the bound is
    a whole-row computation).  Call after scan.build_prune_data(qd,
    pack); with ``delta=True`` the payload is pos, val."""
    _require_prune_data(qd)
    rows = _db_shards(qd, mesh)
    lead = mesh.lead

    def run(state, payload, ok):
        survive = _prune(qd, rows, state, _rebuild(qd, rows, payload),
                         _split(ok, rows))
        return torch.cat([s.to(lead) for s in survive])

    if delta:
        def step(state, pos, val, ok):
            return run(state, (pos, val), ok)
    else:
        def step(state, packed, ok):
            return run(state, packed, ok)
    return step


@dataclass
class SurvivorBuffers:
    """Each db shard's survivor buffer, on its row's first device:
    buf[i] (cap + 1, W) uint8 codes, idx[i] (cap + 1,) int32 global
    database indices, n[i] () int32 fill count.  Row cap is a spill row
    that takes the writes of non-surviving rows (torch has no dropping
    scatter)."""

    buf: list
    idx: list
    n: list
    cap: int

    def fill(self) -> np.ndarray:
        """Each shard's fill count (a host read)."""
        return np.array([int(n) for n in self.n], dtype=np.int64)

    def indices(self) -> np.ndarray:
        """(n_db * cap,) the slots' global indices, in the order of
        flush's flags (a host read)."""
        return np.concatenate([i[:self.cap].cpu().numpy() for i in self.idx])


def make_sharded_survivor_ops(qd: scan.QueryDeviceData, mesh: Mesh,
                              cap_per_shard: int):
    """Device-resident survivor buffers for the sharded pruned scan:
    surviving rows stay on their shard's device until a flush scores
    them (the counterpart of scan.prune_and_hold /
    accumulate_survivors / flush_survivors on one device).

    Returns (init, prune_acc, prune_acc_delta, flush):
      init()                                   -> bufs (SurvivorBuffers)
      prune_acc(state, bufs, packed, ok, ridx) -> (survive, bufs)
      prune_acc_delta(state, bufs, pos, val, ok, ridx) -> same
      flush(state, bufs)                       -> (state, flags, bufs)
        flags (n_db * cap,) bool on mesh.lead, aligned with
        bufs.indices(); slots past a shard's fill are False.  The caller
        MUST flush whenever max(bufs.fill()) + B / n_db > cap (rows past
        cap go to the spill row and are lost, as the JAX package drops
        them).

    The buffers are updated in place.  Requires scan.build_prune_data(qd,
    pack) and qd built with site_shards=mesh.shape['site']."""
    _require_prune_data(qd)
    rows = _db_shards(qd, mesh)
    body = _scan_body(qd, rows, mesh.lead)
    lead = mesh.lead
    cap, W = cap_per_shard, qd.width

    def init():
        parts = [scan.new_survivor_buffer(cap, W, row.dev) for row in rows]
        return SurvivorBuffers(*(list(p) for p in zip(*parts)), cap=cap)

    def prune_acc(state, bufs, payload, ok, ref_idx):
        codes = _rebuild(qd, rows, payload)
        survive = _prune(qd, rows, state, codes, _split(ok, rows))
        for i, (row, idx_r) in enumerate(zip(rows, _split(ref_idx, rows))):
            with _on(row.dev):
                scan.accumulate_survivors(bufs.buf[i], bufs.idx[i],
                                          bufs.n[i], codes[i], survive[i],
                                          0, ref_idx=idx_r)
        return torch.cat([s.to(lead) for s in survive]), bufs

    def prune_acc_delta(state, bufs, pos, val, ok, ref_idx):
        return prune_acc(state, bufs, (pos, val), ok, ref_idx)

    def flush(state, bufs):
        codes, oks, idxs = [], [], []
        for row, buf, idx, n in zip(rows, bufs.buf, bufs.idx, bufs.n):
            with _on(row.dev):
                ok = torch.arange(cap, dtype=torch.int32,
                                  device=row.dev) < n
                # slots past the fill hold stale rows of earlier flushes
                # (the buffers are reused, not cleared): zero their codes
                # and sentinel their indices, so that they can never
                # re-enter the top-k
                codes.append(torch.where(ok[:, None], buf[:cap], 0))
                idxs.append(torch.where(ok, idx[:cap], _SENT))
                oks.append(ok)
        state, flags = body(state, codes, oks, idxs)
        for n in bufs.n:
            n.zero_()
        return state, flags, bufs

    return init, prune_acc, prune_acc_delta, flush
