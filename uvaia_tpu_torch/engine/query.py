"""Query-side preprocessing for the port: the port's copy of
``uvaia_tpu/engine/query.py`` (QC, consensus and site classes,
resolution order, redundancy removal; all citations into the uvaia C
sources).

``QueryPack.exclude_redundant`` computes its pair matrices with jax in
the JAX package; here :func:`exclude_redundant` computes them as int32
numpy products, so ``--keep_resolved`` never needs jax.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..core.encoding import IS_PURE, composition, encode, strict_chars_check
from ..io.fasta import read_fasta_all

__all__ = ["QueryPack", "build_query_pack", "exclude_redundant", "log",
           "qc_filter"]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class QueryPack:
    """All query sequences, encoded and indexed, ready for the scan."""

    names: list[str]
    codes: np.ndarray          # (Q, L) uint8
    acgt: bool
    trim: int
    consensus: np.ndarray = field(default=None)   # (L,) uint8; 0 outside classes
    poly: np.ndarray = field(default=None)        # (L,) bool polymorphic flag
    idx_c: np.ndarray = field(default=None)       # int32 site indices
    idx_m: np.ndarray = field(default=None)
    idx: np.ndarray = field(default=None)

    @property
    def n_query(self) -> int:
        return self.codes.shape[0]

    @property
    def n_sites(self) -> int:
        return self.codes.shape[1]

    @property
    def idx_mq(self) -> np.ndarray:
        """Union of idx_m and idx (sorted) — the per-query compare set."""
        return np.sort(np.concatenate([self.idx_m, self.idx]))

    # ------------------------------------------------------------------

    def _resolved(self) -> np.ndarray:
        """Per-site per-query 'resolved' indicator: valid (full mode) or
        pure ACGT (--acgt mode), matching is_site_valid/is_site_acgt."""
        if self.acgt:
            return IS_PURE[self.codes] != 0
        return self.codes != 0

    def create_indices(self) -> None:
        """Consensus + 3-way site classification (fastaseq.c:732-777)."""
        Q, L = self.codes.shape
        t = self.trim
        window = np.zeros(L, dtype=bool)
        window[t:L - t if t else L] = True

        res = self._resolved()                        # (Q, L)
        any_res = res.any(axis=0)
        miss = (~res).any(axis=0)                     # some query unresolved
        # min/max of codes over resolved entries
        c = self.codes.astype(np.int16)
        cmax = np.where(res, c, -1).max(axis=0)
        cmin = np.where(res, c, 99).min(axis=0)
        poly = any_res & (cmax != cmin)

        self.consensus = np.where(any_res & ~poly, cmax, 0).astype(np.uint8)
        self.consensus[~window] = 0
        self.poly = poly & window

        informative = any_res & window
        sites = np.nonzero(informative)[0].astype(np.int32)
        is_poly = self.poly[sites]
        is_miss = miss[sites]
        self.idx = sites[is_poly]
        self.idx_m = sites[~is_poly & is_miss]
        self.idx_c = sites[~is_poly & ~is_miss]
        log(f"Query sequence alignment: {len(self.idx)} segregating, "
            f"{len(self.idx_m)} non-segregating sites with indels, and "
            f"{len(self.idx_c)} constant sites (all are used in comparisons)")

    def resolution_counts(self) -> np.ndarray:
        """non-N (or ACGT in --acgt mode) counts over the trimmed window
        (fastaseq.c:786-787)."""
        t = self.trim
        sl = slice(t, self.n_sites - t if t else self.n_sites)
        return self._resolved()[:, sl].sum(axis=1).astype(np.int64)

    def reorder_by_resolution(self) -> None:
        """Sort queries from lower to higher resolution (fastaseq.c:779-795)."""
        counts = self.resolution_counts()
        order = np.argsort(counts, kind="stable")
        self.codes = self.codes[order]
        self.names = [self.names[i] for i in order]


def qc_filter(names: list[str], seqs: list[bytes], ambiguity: float,
              check_aligned: bool) -> tuple[list[str], list[bytes]]:
    """Drop low-quality sequences (utils.c:11-48): shorter than 5 bp,
    N-fraction above `ambiguity`, or ACGT fraction below 1-1.1*ambiguity.
    Errors out on unaligned input when check_aligned."""
    keep_n, keep_s, lengths = [], [], set()
    for name, seq in zip(names, seqs):
        if len(seq) < 5:
            log(f"Sequence {name} is too short ( = {len(seq)} sites), "
                "limit is hardcoded at 5bps.")
            continue
        codes = encode(seq)
        strict_chars_check(name, seq if isinstance(seq, bytes)
                           else bytes(seq))
        acgt, _amb, other = composition(codes)
        if other > ambiguity:
            log(f"Sequence {name} has proportion of N etc. (={other:f}) "
                f"above threshold of {ambiguity:f}")
            continue
        if acgt < 1.0 - 1.1 * ambiguity:
            log(f"Sequence {name} has proportion of ACGT (={acgt:f}) below "
                f"threshold of {1.0 - 1.1 * ambiguity:f}")
            continue
        keep_n.append(name)
        keep_s.append(seq)
        lengths.add(len(seq))
    if check_aligned and len(lengths) > 1:
        raise SystemExit("Query sequences are not aligned. You can use "
                         "uvaia-tpu align to align them against the same "
                         "reference.")
    return keep_n, keep_s


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
                     keep_resolved: bool | None = None,
                     always_exclude_redundant: bool = False) -> QueryPack:
    """Load + preprocess queries, mirroring nearest.c:202-224 /
    ball.c:173-194 (the same steps, log lines and order as
    uvaia_tpu.engine.query.build_query_pack; the redundancy removal is
    :func:`exclude_redundant`, which `ball` always runs)."""
    recs = read_fasta_all(path)
    names = [r.name for r in recs]
    seqs = [r.seq for r in recs]
    log(f"Finished reading {len(names)} query sequences")
    names, seqs = qc_filter(names, seqs, ambiguity, check_aligned=True)
    log(f"Query database composed of {len(names)} valid sequences, "
        "after excluding low quality.")
    if not names:
        raise SystemExit(f"No valid query sequences found in {path}.")
    L = len(seqs[0])
    trim = max(0, min(trim, int(L / 2.1)))
    codes = np.stack([encode(s) for s in seqs])
    pack = QueryPack(names=names, codes=codes, acgt=acgt, trim=trim)
    pack.create_indices()
    pack.reorder_by_resolution()
    if always_exclude_redundant or keep_resolved:
        removed = exclude_redundant(pack, bool(keep_resolved))
        log(f"Updated query database composed of {pack.n_query} valid "
            f"sequences, after removing {removed} redundant sequences.")
        pack.create_indices()
    return pack
