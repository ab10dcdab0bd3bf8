"""The yardstick of the kernels' roofline shares: the H100's published
peaks and the least time a kernel could take.

Frozen copy of ``chip_smoke.py`` at commit 0e5ecf2 (``INT8_OPS_PER_S``,
``INT32_OPS_PER_S``, ``BYTES_PER_S``, ``GOTOH_CELL_OPS``, ``bound``,
``counter_bound``), so that later edits of that script cannot move it.
The serial-chain term of ``bound`` is left out: it is a latency, not a
peak, and a share of it could pass 100%.
"""

from __future__ import annotations

# one H100 SXM: dense int8 tensor cores and HBM3 from NVIDIA's data
# sheet; the CUDA-core int32 rate as 132 SMs x 64 int32 lanes x the
# 1.98 GHz boost clock
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
# integer operations per banded Gotoh cell: three adds, four mins and the
# substitution select, plus two for the traceback bits (forward only)
GOTOH_CELL_OPS = {"gotoh_forward": 10, "gotoh_score": 8}
# counter kernels in full mode: 9 feature planes, 3 int32 outputs a pair
FULL_PLANES, FULL_OUTPUTS = 9, 3


def bound_s(nbytes: float, int8_ops: float = 0.0,
            int32_ops: float = 0.0) -> float:
    """Seconds: the larger of the bytes over the memory rate and the
    operations over their peak rate."""
    return max(nbytes / BYTES_PER_S, int8_ops / INT8_OPS_PER_S,
               int32_ops / INT32_OPS_PER_S)


def counter_work(rows: int, queries: int, sites: int, launches: int,
                 planes: int = FULL_PLANES,
                 n_out: int = FULL_OUTPUTS) -> dict:
    """Operations and bytes of `launches` counter-kernel launches that
    score `rows` rows in all (chip_smoke's counter_bound, summed): 2 x
    rows x queries x planes x sites int8 operations; each reference row
    and its consensus flags read once, the query planes and the
    consensus once a launch, each output written once."""
    ops = 2.0 * rows * queries * planes * sites
    nbytes = (rows * sites + launches * queries * sites
              + n_out * rows * queries * 4 + launches * sites + 20 * rows)
    return dict(int8_ops=ops, nbytes=nbytes)


def gotoh_forward_work(n: int, widths, query_bytes: int) -> dict:
    """Operations and bytes of the traceback-emitting banded forward over
    rows of band widths `widths` against a reference of n bases
    (chip_smoke's phase_gotoh bound without the chain term): 10 int32
    operations a cell; the reference once, each query byte once, a
    traceback byte a cell, 16 bytes of lengths and results a row."""
    cells = sum(n * w for w in widths)
    return dict(int32_ops=GOTOH_CELL_OPS["gotoh_forward"] * cells,
                nbytes=n + query_bytes + 16 * len(widths) + cells)
