"""Banded affine Gotoh forward and the events traceback walk: kernels
and their plain PyTorch versions.

* :func:`gotoh_forward` (csrc/gotoh.cu, traceback-emitting) replaces
  ``uvaia_tpu/ops/pallas_gotoh.py:_fwd_kernel``;
* :func:`gotoh_score` (csrc/gotoh.cu, score only) replaces
  ``pallas_gotoh.py:_score_kernel``;
* :func:`walk_events` (csrc/walk.cu) walks the traceback buffer into
  the events form on the card; it replaces no Pallas kernel but the
  ``lax.while_loop`` of ``uvaia_tpu.ops.gotoh.gotoh_traceback_events``,
  whose torch version, :func:`.gotoh.walk_events_plain`, is its plain
  version.

The two forward kernels compute the row recurrence of
``uvaia_tpu.ops.gotoh._row_kernel`` (match 0, mismatch 4, gap of length
g costs 6 + 2g; band slot t of row i is column j = i + lo + t) with the
same int32 saturation points and tie rules, so a kernel equals its
plain version at every cell of the traceback buffer, not only at the
cells a walk reaches.

Each wrapper launches its CUDA kernel for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs the plain
version beside it, and for any other device it raises.  There is no
fallback from a CUDA tensor to a plain version.
"""

from __future__ import annotations

import torch

from ..utils import observe
from . import _build
from .gotoh import (GAP_EXT, GAP_OPEN, INF, MISMATCH, OE, events_cap,
                    walk_events_plain)

# The register kernel of csrc/gotoh.cu keeps a thread's band slots in
# registers: these slot counts are compiled, for one warp a query row
# (no barrier in the row loop) or a CTA of up to REG_MAX_WARPS warps
# (one barrier a row).
REG_SLOTS = (1, 2, 3, 4, 5, 6, 9, 17)
REG_MAX_WARPS = 8
WARP_MAX_WIDTH = 32 * REG_SLOTS[-1]
REG_MAX_WIDTH = REG_MAX_WARPS * WARP_MAX_WIDTH
# The wide kernel (beyond REG_MAX_WIDTH) double buffers the H and X rows
# in the H100's 227 KB of shared memory per block, 16 bytes per band
# slot; wider bands keep them in a device-memory scratch buffer that the
# wrapper allocates.
SMEM_BYTES = 232448 - 1024
HX_SMEM_MAX_WIDTH = SMEM_BYTES // 16


def forward_plan(width: int) -> tuple[int, int]:
    """(slots, warps) of the kernel variant for a band of `width` slots,
    from the width alone: the fewest slots a thread that let one warp
    cover the band (width <= WARP_MAX_WIDTH), else the fewest that let
    REG_MAX_WARPS warps cover it, with as many warps as the band then
    needs; (0, 0), the wide kernel, beyond REG_MAX_WIDTH."""
    for max_warps in (1, REG_MAX_WARPS):
        for slots in REG_SLOTS:
            if 32 * max_warps * slots >= width:
                return slots, -(-width // (32 * slots))
    return 0, 0


# ----------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held
# against on the card)


def _row0(qlen: torch.Tensor, lo: int, W: int):
    """Row 0: H = cost of j leading insertions (INF left of column 0
    and past the query end), X = INF, edge = min(H[0], H[W-1])."""
    slots = torch.arange(W, dtype=torch.int32, device=qlen.device)
    j0 = slots + lo
    h0 = torch.where(j0 == 0, 0,
                     torch.where(j0 > 0, GAP_OPEN + GAP_EXT * j0, INF))
    h = torch.where(j0[None, :] > qlen[:, None], INF,
                    h0[None, :].to(torch.int32)).to(torch.int32)
    x = torch.full_like(h, INF)
    edge = torch.minimum(h[:, 0], h[:, W - 1])
    return slots, h, x, edge


def _query_window(q: torch.Tensor, lo: int, W: int, n: int):
    """(qp, off): q padded with zeros so that the band window of row i,
    query bytes q[i + lo - 1 .. i + lo + W - 2] (zero outside q), is
    qp[:, i + lo - 1 + off : ... + W] for every i in 1..n."""
    B, m_pad = q.shape
    off = max(-lo, 0)
    total = max(off + m_pad, n + lo - 1 + off + W) + 1
    qp = torch.zeros((B, total), dtype=torch.uint8, device=q.device)
    qp[:, off:off + m_pad] = q
    return qp, off


def _forward_plain(ref, q, qlen, lo: int, W: int, emit_tb: bool):
    """Rows 1..n of gotoh._row_kernel over (B, W) int32 tensors.
    Returns (tb (n, B, W) uint8 or None, final H row, edge_min)."""
    n = ref.shape[0]
    B = q.shape[0]
    qlen = qlen.to(torch.int32)
    slots, h, x, edge = _row0(qlen, lo, W)
    qp, off = _query_window(q, lo, W, n)
    inf_col = torch.full((B, 1), INF, dtype=torch.int32, device=q.device)
    ref_h = ref.cpu().tolist()
    tb = (torch.empty((n, B, W), dtype=torch.uint8, device=q.device)
          if emit_tb else None)
    for i in range(1, n + 1):
        j = i + lo + slots
        jv = (j >= 0)[None, :] & (j[None, :] <= qlen[:, None])
        s = i + lo - 1 + off
        qwin = qp[:, s:s + W]
        sub = torch.where(qwin == ref_h[i - 1], 0, MISMATCH)
        sub = torch.where((j[None, :] >= 1) & (j[None, :] <= qlen[:, None]),
                          sub, INF).to(torch.int32)
        m_row = h + sub
        x_open = torch.cat([h[:, 1:], inf_col], dim=1) + OE
        x_ext = torch.cat([x[:, 1:], inf_col], dim=1) + GAP_EXT
        x_row = torch.minimum(x_open, x_ext)
        g_row = torch.minimum(m_row, x_row)
        # y (query-consuming gap): prefix cummin of g[s] - s*e, shifted
        c = torch.cummin(g_row - slots[None, :] * GAP_EXT, dim=1).values
        y_row = torch.cat([inf_col, OE + (slots[1:] - 1)[None, :] * GAP_EXT
                           + c[:, :-1]], dim=1)
        y_row = torch.clamp(y_row, max=INF)
        h_row = torch.where(jv, torch.minimum(g_row, y_row), INF)
        h_row = torch.clamp(h_row, max=INF)
        x_out = torch.clamp(torch.where(jv, x_row, INF), max=INF)
        if emit_tb:
            y_open = torch.cat([inf_col, g_row[:, :-1] + OE], dim=1)
            g_from_x = x_out < m_row
            src = torch.where(y_row < g_row, 2, g_from_x.to(torch.int32))
            tb[i - 1] = (src | ((x_ext <= x_open).to(torch.int32) << 2)
                         | ((y_row < y_open).to(torch.int32) << 3)
                         | (g_from_x.to(torch.int32) << 4)).to(torch.uint8)
        edge = torch.minimum(edge, torch.minimum(h_row[:, 0],
                                                 h_row[:, W - 1]))
        h, x = h_row, x_out
    return tb, h, edge


def final_score(h_fin: torch.Tensor, qlen: torch.Tensor, lo: int, n: int,
                W: int):
    """gotoh._final_score: (score, t_end) from the last H row."""
    t_end = qlen.to(torch.int32) - n - lo
    rows = torch.arange(h_fin.shape[0], device=h_fin.device)
    score = h_fin[rows, torch.clamp(t_end, 0, W - 1).long()]
    score = torch.where((t_end >= 0) & (t_end < W), score, INF)
    return score.to(torch.int32), t_end


def gotoh_forward_plain(ref, q, qlen, lo: int, width: int):
    """(tb (n, B, W) uint8, score (B,), t_end (B,), edge_min (B,))."""
    tb, h, edge = _forward_plain(ref, q, qlen, lo, width, True)
    score, t_end = final_score(h, qlen, lo, ref.shape[0], width)
    return tb, score, t_end, edge


def gotoh_score_plain(ref, q, qlen, lo: int, width: int):
    """(score (B,), edge_min (B,))."""
    _, h, edge = _forward_plain(ref, q, qlen, lo, width, False)
    score, _ = final_score(h, qlen, lo, ref.shape[0], width)
    return score, edge


# ----------------------------------------------------------------------
# wrappers


def _check(ref, q, qlen, width: int) -> None:
    if ref.dtype != torch.uint8 or ref.dim() != 1 or ref.shape[0] == 0:
        raise ValueError("ref must be a non-empty 1-D uint8 tensor")
    if q.dtype != torch.uint8 or q.dim() != 2:
        raise ValueError("q must be a 2-D uint8 tensor")
    if qlen.dtype != torch.int32 or qlen.shape != (q.shape[0],):
        raise ValueError(f"qlen must be ({q.shape[0]},) int32")
    if not (ref.device == q.device == qlen.device):
        raise ValueError("ref, q and qlen must share one device")
    if not (ref.is_contiguous() and q.is_contiguous()
            and qlen.is_contiguous()):
        raise ValueError("ref, q and qlen must be contiguous")
    if width < 1:
        raise ValueError(f"band width {width} must be at least 1")


def _launch(ref, q, qlen, lo: int, W: int, emit_tb: bool, plan=None):
    """Launch the forward kernel; `plan` (slots, warps) overrides
    forward_plan(W) for the tuning script."""
    n = ref.shape[0]
    B, m_pad = q.shape
    dev = q.device
    i32 = dict(dtype=torch.int32, device=dev)
    score, t_end, edge = (torch.empty(B, **i32) for _ in range(3))
    tb = (torch.empty((n, B, W), dtype=torch.uint8, device=dev)
          if emit_tb else None)
    if B == 0:
        return tb, score, t_end, edge
    slots, warps = forward_plan(W) if plan is None else plan
    # the wide kernel's H and X beyond the shared-memory budget live in
    # device memory: (B, 4, W) int32, two rows of each, double buffered
    scratch = (torch.empty((B, 4, W), **i32)
               if slots == 0 and W > HX_SMEM_MAX_WIDTH else None)
    sp = 0 if scratch is None else scratch.data_ptr()
    lib = _build.lib()
    if emit_tb:
        rc = lib.uvt_gotoh_forward(
            ref.data_ptr(), n, q.data_ptr(), B, m_pad, qlen.data_ptr(), lo,
            W, tb.data_ptr(), score.data_ptr(), t_end.data_ptr(),
            edge.data_ptr(), sp, slots, warps, _build.stream_ptr(q))
    else:
        rc = lib.uvt_gotoh_score(
            ref.data_ptr(), n, q.data_ptr(), B, m_pad, qlen.data_ptr(), lo,
            W, score.data_ptr(), edge.data_ptr(), sp, slots, warps,
            _build.stream_ptr(q))
    _build.check(rc, "gotoh_forward" if emit_tb else "gotoh_score")
    return tb, score, t_end, edge


def gotoh_forward(ref: torch.Tensor, q: torch.Tensor, qlen: torch.Tensor,
                  lo: int, width: int):
    """Forward DP with packed traceback emission, as
    uvaia_tpu.ops.gotoh.gotoh_forward.

    ref  — (n,) uint8 reference bytes
    q    — (B, m_pad) uint8 query bytes (left-aligned, zero padded)
    qlen — (B,) int32 true query lengths
    lo   — diagonal offset of band slot 0 (d = j - i in [lo, lo+width))
    Returns (tb (n, B, W) uint8, score (B,), t_end (B,), edge_min (B,)),
    all int32 but tb.
    """
    _check(ref, q, qlen, width)
    if not _build.use_kernel(q):
        return gotoh_forward_plain(ref, q, qlen, lo, width)
    out = _launch(ref, q, qlen, lo, width, True)
    gotoh_forward.launches += 1
    return out


gotoh_forward.launches = 0


def gotoh_score(ref: torch.Tensor, q: torch.Tensor, qlen: torch.Tensor,
                lo: int, width: int):
    """Score-only forward (no traceback buffer), as
    uvaia_tpu.ops.gotoh.gotoh_score: (score (B,), edge_min (B,))."""
    _check(ref, q, qlen, width)
    if not _build.use_kernel(q):
        return gotoh_score_plain(ref, q, qlen, lo, width)
    _, score, _, edge = _launch(ref, q, qlen, lo, width, False)
    gotoh_score.launches += 1
    return score, edge


gotoh_score.launches = 0


def allm_flags(tb: torch.Tensor, n: int):
    """The events walk's all-M flags from the kernel of csrc/walk.cu:
    (allm1 (n1, B, W), allm2 (n2, B, W)) uint8, as
    gotoh._all_m_blocks (n1 = ceil(n / 256), n2 = ceil(n1 / 16))."""
    _, B, W = tb.shape
    n1 = -(-n // 256)
    n2 = -(-n1 // 16)
    allm1 = torch.empty((n1, B, W), dtype=torch.uint8, device=tb.device)
    allm2 = torch.empty((n2, B, W), dtype=torch.uint8, device=tb.device)
    _build.check(_build.lib().uvt_allm_flags(
        tb.data_ptr(), n, B, W, allm1.data_ptr(), allm2.data_ptr(),
        _build.stream_ptr(tb)), "allm_flags")
    return allm1, allm2


def walk_events(tb: torch.Tensor, t_end: torch.Tensor, lo: int, n: int,
                K: int):
    """The events traceback walk (gotoh.gotoh_traceback_events) of
    tb (n, B, W) uint8 from (n, t_end (B,) int32): (ev_i (B, K) int32,
    ev_t (B, K) int32, cnt (B,) int32, done, edge, ovf (B,) bool),
    equal to gotoh.walk_events_plain's on any bytes.  On the card two
    launches on the current stream, the all-M flags and the walk, and
    no host read."""
    if not _build.use_kernel(tb):
        return walk_events_plain(tb, t_end, lo, n, K)
    if tb.dtype != torch.uint8 or tb.dim() != 3 or tb.shape[0] != n:
        raise ValueError(f"tb must be a ({n}, B, W) uint8 tensor")
    _, B, W = tb.shape
    if t_end.dtype != torch.int32 or t_end.shape != (B,):
        raise ValueError(f"t_end must be ({B},) int32")
    if t_end.device != tb.device:
        raise ValueError("tb and t_end must share one device")
    if not (tb.is_contiguous() and t_end.is_contiguous()):
        raise ValueError("tb and t_end must be contiguous")
    if n < 1 or K < 0:
        raise ValueError(f"n = {n} must be at least 1 and K = {K} not "
                         "negative")
    dev = tb.device
    ev_i, ev_t = (torch.empty((B, K), dtype=torch.int32, device=dev)
                  for _ in range(2))
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    done, edge, ovf = (torch.empty(B, dtype=torch.bool, device=dev)
                       for _ in range(3))
    if B == 0:
        return ev_i, ev_t, cnt, done, edge, ovf
    allm1, allm2 = allm_flags(tb, n)
    _build.check(_build.lib().uvt_walk_events(
        tb.data_ptr(), n, B, W, t_end.data_ptr(), lo, K, allm1.data_ptr(),
        allm2.data_ptr(), events_cap(n, W), ev_i.data_ptr(), ev_t.data_ptr(),
        cnt.data_ptr(), done.data_ptr(), edge.data_ptr(), ovf.data_ptr(),
        _build.stream_ptr(tb)), "walk_events")
    walk_events.launches += 1
    observe.count("walk_kernel_rows", B)
    return ev_i, ev_t, cnt, done, edge, ovf


walk_events.launches = 0
