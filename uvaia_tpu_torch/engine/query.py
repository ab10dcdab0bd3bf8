"""Query-side preprocessing for the port.

Reuses ``uvaia_tpu.engine.query`` (QC, site classes, resolution order),
which is numpy code, except ``QueryPack.exclude_redundant``: that one
computes its pair matrices with jax, and here they are int32 numpy
products, so ``--keep_resolved`` never imports jax.
"""

from __future__ import annotations

import numpy as np

from uvaia_tpu.core.encoding import IS_PURE
from uvaia_tpu.engine.query import QueryPack, log
from uvaia_tpu.engine.query import build_query_pack as _build_pack

__all__ = ["QueryPack", "build_query_pack", "exclude_redundant", "log"]


def _dot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(Q, S) x (Q, S) 0/1 int8 -> (Q, Q) int32 (int32 accumulation:
    an int8 product would wrap above 127)."""
    return a.astype(np.int32) @ b.astype(np.int32).T


def exclude_redundant(pack: QueryPack, keep_more_resolved: bool) -> int:
    """Drop redundant queries (fastaseq.c:797-841) from ``pack`` in
    place; returns the number removed.  The same pair matrices and the
    same sequential elimination walk as
    uvaia_tpu.engine.query.QueryPack.exclude_redundant."""
    if pack.consensus is None:
        raise RuntimeError("create_indices() must run first")
    Q = pack.n_query
    codes = pack.codes

    sub = codes[:, pack.idx]                            # (Q, P)
    active = (IS_PURE[sub] != 0) if pack.acgt else (sub != 0)
    # conflict(i, j): some site active in both with different codes
    # <=> (#both-active) > (#both-active-and-equal)
    act = active.astype(np.int8)
    both_act = _dot(act, act)
    both_eq = np.zeros_like(both_act)
    for c in range(1, 15):
        m_c = (sub == c).astype(np.int8) * act
        both_eq += _dot(m_c, m_c)
    conflict_m = both_act > both_eq                     # (Q, Q) bool

    def lr_mats(ix):
        s = codes[:, ix]
        r = ((IS_PURE[s] != 0) if pack.acgt else (s != 0)).astype(np.int8)
        return _dot(r, 1 - r) > 0        # a[i, j]: i resolved where j not

    a_p = lr_mats(pack.idx)
    a_m = lr_mats(pack.idx_m)

    def lr(a, i, j) -> int:
        """left_is_resolved_right (fastaseq.c:598-640): -1 left more
        resolved, +1 right, 0 identical, 0xff incomparable."""
        if a[i, j] and a[j, i]:
            return 0xff
        if a[i, j]:
            return -1
        if a[j, i]:
            return 1
        return 0

    valid_q = np.ones(Q, dtype=bool)
    for i in range(Q - 1):
        if not valid_q[i]:
            continue
        cands = np.nonzero(~conflict_m[i, i + 1:])[0] + i + 1
        for j in cands:
            if not (valid_q[i] and valid_q[j]):
                continue
            red1 = lr(a_p, i, j)
            if red1 > 1:
                continue
            red2 = lr(a_m, i, j)
            if red2 > 1:
                continue
            if red1 == 0 and red2 == 0:
                valid_q[j] = False
                continue
            red = red1 + red2
            if red == 0:
                continue  # complementary SNP info, keep both
            if keep_more_resolved:
                if red > 0:
                    valid_q[i] = False
                else:
                    valid_q[j] = False
            else:
                if red > 0:
                    valid_q[j] = False
                else:
                    valid_q[i] = False
    removed = int(Q - valid_q.sum())
    if removed:
        pack.codes = pack.codes[valid_q]
        pack.names = [n for n, v in zip(pack.names, valid_q) if v]
    return removed


def build_query_pack(path: str, trim: int = 0, acgt: bool = False,
                     ambiguity: float = 0.5,
                     keep_resolved: bool | None = None) -> QueryPack:
    """uvaia_tpu.engine.query.build_query_pack with the redundancy
    removal done by :func:`exclude_redundant` (same steps, same log
    lines, same order)."""
    pack = _build_pack(path, trim=trim, acgt=acgt, ambiguity=ambiguity,
                       keep_resolved=False)
    if keep_resolved:
        removed = exclude_redundant(pack, bool(keep_resolved))
        log(f"Updated query database composed of {pack.n_query} valid "
            f"sequences, after removing {removed} redundant sequences.")
        pack.create_indices()
    return pack
