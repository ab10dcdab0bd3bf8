"""Sparse-delta row rebuild: :func:`delta_rebuild` (csrc/recon.cu)
replaces ``uvaia_tpu/ops/pallas_recon.py:_kernel`` together with the
zero-run unmask ``uvaia_tpu/ops/scan.py:_unmask_runs``.

The wrapper launches the kernel for CUDA tensors (counting it in
``delta_rebuild.launches``) and runs :func:`delta_rebuild_plain` for
CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from . import _build

# shared memory a CTA of the H100 may use, and what the kernel asks of
# it: the row (rounded up to 16 bytes, plus 16), 8 bytes an entry and
# some scan scratch
SHARED_BYTES = 232448
MAX_ENTRIES = 4096            # ops/host.DELTA_BUCKETS[-1]
# the widest row that fits beside MAX_ENTRIES entries
MAX_WIDTH = SHARED_BYTES - 8 * MAX_ENTRIES - 96


def unmask_runs(img: torch.Tensor) -> torch.Tensor:
    """Decode zero-run markers painted into a rebuilt image: 16 starts
    a run of zeros, 32 + code ends it (carrying the code of the first
    site after the run); a run with no end marker reaches the row end.
    Same arithmetic as uvaia_tpu.ops.scan._unmask_runs."""
    v = img.to(torch.int32)
    s_m = (v >= 16) & (v < 32)
    e_m = v >= 32
    inside = torch.cumsum(s_m.to(torch.int32) - e_m.to(torch.int32),
                          dim=1) > 0
    out = torch.where(e_m, v - 32, torch.where(s_m, 0, v))
    return torch.where(inside, 0, out).to(torch.uint8)


def delta_rebuild_plain(pos: torch.Tensor, val: torch.Tensor,
                        base: torch.Tensor, width: int) -> torch.Tensor:
    """(B, width) uint8 codes: base, then the entries with pos < L
    painted over it (the rest dropped), then the run unmask."""
    B = pos.shape[0]
    L = base.shape[0]
    p = pos.to(torch.int64)
    # torch raises on out-of-range scatter indices (JAX drops them):
    # send every dropped entry to one spare column, sliced off below
    p = torch.where(p < L, p, L)
    img = torch.cat([base, base.new_zeros(1)])[None, :].repeat(B, 1)
    img.scatter_(1, p, val)
    img = img[:, :L]
    if width > L:
        img = torch.nn.functional.pad(img, (0, width - L))
    return unmask_runs(img[:, :width])


def delta_rebuild(pos: torch.Tensor, val: torch.Tensor, base: torch.Tensor,
                  width: int | None = None) -> torch.Tensor:
    """Device-side inverse of ops/host.delta_encode: pos (B, E) uint16
    or int32, val (B, E) uint8, base (L,) uint8 -> (B, width) uint8
    (width defaults to L; columns past L are zero).

    The contract, as the plain version has it: base holds codes 0-15
    (ops/host.majority_code); a row's positions below L are unique;
    entries with pos >= L are dropped.  The positions may come in any
    order: the kernel is at its fastest on what ops/host.delta_encode
    and the sequence store hold (real entries first, ascending, then
    the padding).  A row with run markers in another order, which no
    command produces, takes a prefix sum over its sites: a safety path
    that keeps the kernel equal to the plain version on any input."""
    L = base.shape[0]
    w = L if width is None else int(width)
    if pos.shape != val.shape or pos.dim() != 2:
        raise ValueError(f"pos {tuple(pos.shape)} and val "
                         f"{tuple(val.shape)} must be the same (B, E)")
    if pos.dtype not in (torch.uint16, torch.int32):
        raise ValueError(f"pos must be uint16 or int32, not {pos.dtype}")
    if val.dtype != torch.uint8 or base.dtype != torch.uint8:
        raise ValueError("val and base must be uint8")
    if not (pos.device == val.device == base.device):
        raise ValueError("pos, val and base must share one device")
    if not (pos.is_contiguous() and val.is_contiguous()
            and base.is_contiguous()):
        raise ValueError("pos, val and base must be contiguous")
    if w < L:
        raise ValueError(f"width {w} is below the base length {L}")
    if not _build.use_kernel(pos):
        return delta_rebuild_plain(pos, val, base, w)
    B, E = pos.shape
    if (w + 15) // 16 * 16 + 80 + 8 * E > SHARED_BYTES:
        raise ValueError(
            f"width {w} with {E} entries a row exceeds the rebuild "
            f"kernel's shared memory (width <= {MAX_WIDTH} at up to "
            f"{MAX_ENTRIES} entries)")
    out = torch.empty((B, w), dtype=torch.uint8, device=pos.device)
    if B == 0:
        return out
    rc = _build.lib().uvt_delta_rebuild(
        pos.data_ptr(), pos.element_size(), val.data_ptr(),
        base.data_ptr(), B, E, L, w, out.data_ptr(),
        _build.stream_ptr(pos))
    _build.check(rc, "delta_rebuild")
    delta_rebuild.launches += 1
    return out


delta_rebuild.launches = 0
