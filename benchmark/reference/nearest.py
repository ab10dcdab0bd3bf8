"""Plain reference of `nearest` in full mode: QC, the six scores of a
query against every database row, and the ranked top k.

Written from uvaia's definitions (nearest.c:130-152, README.md:254-330,
utils.c:11-48, fastaseq.c:732-795) in numpy and plain torch; a frozen
copy of the numpy oracle of ``chip_smoke.py`` at commit 0e5ecf2
(``oracle_topk``) is ``oracle_topk`` below and serves the tests.  It
imports nothing of the program and works from the generated letters,
never from the program's store or query pack.

Codes: A=1, C=2, G=4, T=8, an IUPAC letter the OR of its bases, 0 for N
and gaps.  For a query q and a database row r, over all sites:
  s0  ACGT matches: q == r, both non-zero, q a pure base
  s1  text matches: q == r, both non-zero
  s2  partial matches: (q & r) != 0
  s3  valid pairs: q != 0 and r != 0
  s4  s0 over the sites where the query set is not constant (some query
      N there, or two queries differ)
  s5  valid sites of r
Rows rank by (s0, ..., s5) descending, ties to the earlier row.
With a trim of t sites (``trimmed``), s0-s4 and the queries' order count
only the sites between the first t and the last t; s5 and the QC count
every site.
"""

from __future__ import annotations

import numpy as np
import torch

_IUPAC = {"A": 1, "C": 2, "G": 4, "T": 8, "U": 8, "M": 3, "R": 5,
          "W": 9, "S": 6, "Y": 10, "K": 12, "V": 7, "H": 11, "D": 13,
          "B": 14}
LUT = np.zeros(256, dtype=np.uint8)
for _ch, _c in _IUPAC.items():
    LUT[ord(_ch)] = _c
    LUT[ord(_ch.lower())] = _c
PURE = np.isin(np.arange(16), (1, 2, 4, 8))
POPCOUNT = np.array([bin(i).count("1") for i in range(16)])


def codes(letters: np.ndarray) -> np.ndarray:
    return LUT[letters]


def composition(c: np.ndarray):
    """(ACGT share, other share) of each row of codes."""
    L = c.shape[-1]
    acgt = PURE[c].sum(-1) / L
    other = (c == 0).sum(-1) / L
    return acgt, other


def query_qc(c: np.ndarray, ambiguity: float) -> np.ndarray:
    """Queries kept: N share at most `ambiguity`, ACGT share at least
    1 - 1.1 x `ambiguity`, at least 5 sites (utils.c:11-48)."""
    acgt, other = composition(c)
    return (other <= ambiguity) & (acgt >= 1.0 - 1.1 * ambiguity) & \
        (c.shape[-1] >= 5)


def db_valid(c: np.ndarray, ref_ambiguity: float) -> np.ndarray:
    """Database rows scanned: at least L x (1 - ref_ambiguity) valid
    sites (nearest.c:255-270)."""
    return (c != 0).sum(-1) >= int(c.shape[-1] * (1.0 - ref_ambiguity))


def trimmed(c: np.ndarray, trim: int) -> np.ndarray:
    """Query codes with the `trim` sites at each end read as N (code 0),
    the trim cut to int(L / 2.1) as uvaia cuts it."""
    L = c.shape[-1]
    t = max(0, min(trim, int(L / 2.1)))
    out = c.copy()
    if t:
        out[..., :t] = 0
        out[..., L - t:] = 0
    return out


def query_order(c: np.ndarray) -> np.ndarray:
    """Queries from the least to the most resolved, stable
    (fastaseq.c:779-795)."""
    return np.argsort((c != 0).sum(1), kind="stable")


def nonconstant_sites(q: np.ndarray) -> np.ndarray:
    """(L,) bool: sites where some query is N or two queries differ."""
    return ~((q != 0).all(0) & (q == q[:1]).all(0))


class Scorer:
    """The database's codes on a device; six scores of one query
    against every row, in blocks of rows."""

    def __init__(self, db_codes: np.ndarray, device, block: int = 4096):
        self.dev = torch.device(device)
        self.db = torch.from_numpy(db_codes).to(self.dev)
        self.block = block
        self.pure = torch.from_numpy(PURE).to(self.dev)
        self.s5 = torch.cat([(self.db[i:i + block] != 0).sum(1)
                             for i in range(0, self.db.shape[0], block)])

    def scores(self, q: np.ndarray, nonconst: np.ndarray) -> np.ndarray:
        """(R, 6) int64 scores of query codes q (L,)."""
        qd = torch.from_numpy(q).to(self.dev)
        qnz = qd != 0
        qpure = self.pure[qd.long()]
        nc = torch.from_numpy(nonconst).to(self.dev) & qpure
        out = []
        for i in range(0, self.db.shape[0], self.block):
            r = self.db[i:i + self.block]
            valid = (r != 0) & qnz
            eq = (r == qd) & valid
            s0 = (eq & qpure).sum(1)
            s1 = eq.sum(1)
            s2 = ((r & qd) != 0).sum(1)
            s3 = valid.sum(1)
            s4 = (eq & nc).sum(1)
            out.append(torch.stack([s0, s1, s2, s3, s4,
                                    self.s5[i:i + self.block]], 1))
        return torch.cat(out).cpu().numpy()


def rank_topk(scores: np.ndarray, rows: np.ndarray, k: int):
    """The top k of `rows` by the six scores descending, ties to the
    lower row: (rows (<=k,), scores (<=k, 6))."""
    s = scores[rows]
    order = np.lexsort((rows,) + tuple(-s[:, j] for j in range(5, -1, -1)))
    top = order[:k]
    return rows[top], s[top]


def topk(scorer: Scorer, q: np.ndarray, nonconst: np.ndarray,
         valid_rows: np.ndarray, k: int):
    """The ranked top k of one query: (rows, scores)."""
    return rank_topk(scorer.scores(q, nonconst), valid_rows, k)


def ambiguity_as_n(c: np.ndarray) -> np.ndarray:
    """The control's reading: every IUPAC ambiguity code taken as N,
    as a 2-bit base encoding would store it."""
    return np.where(PURE[c], c, 0).astype(np.uint8)


# ----------------------------------------------------------------------
# frozen copy of chip_smoke.py's numpy oracle (commit 0e5ecf2), over the
# site classes of a query set; the tests hold Scorer against it


def _oracle_rank(scores: np.ndarray, k: int):
    order = np.lexsort(tuple(-scores[:, j] for j in range(5, -1, -1)))[:k]
    return scores[order], order


def site_classes(q: np.ndarray):
    """(consensus, idx_c, idx_mq) of a query set at trim 0, as
    uvaia's fastaseq.c:732-777 classifies sites."""
    res = q != 0
    any_res = res.any(0)
    miss = (~res).any(0)
    c = q.astype(np.int16)
    cmax = np.where(res, c, -1).max(0)
    cmin = np.where(res, c, 99).min(0)
    poly = any_res & (cmax != cmin)
    consensus = np.where(any_res & ~poly, cmax, 0).astype(np.uint8)
    sites = np.nonzero(any_res)[0]
    idx_c = sites[~poly[sites] & ~miss[sites]]
    idx_mq = sites[poly[sites] | miss[sites]]
    return consensus, idx_c, idx_mq


def oracle_topk(db: np.ndarray, q: np.ndarray, k: int):
    """Independent numpy oracle: (scores (Q, k, 6), idx (Q, k))."""
    consensus, idx_c, idx_mq = site_classes(q)

    def counters(a, r):
        valid = (a != 0) & (r != 0)
        eq = (a == r) & valid
        pure = np.isin(a, (1, 2, 4, 8))
        return ((eq & pure).sum(1), eq.sum(1), ((a & r) != 0).sum(1),
                valid.sum(1))
    c = counters(consensus[idx_c], db[:, idx_c])
    valid_ref = (db != 0).sum(1)
    out = [_oracle_rank(np.stack([c[j] + m[j] for j in range(4)]
                                 + [m[0], valid_ref], axis=1), k)
           for m in (counters(qi[idx_mq], db[:, idx_mq]) for qi in q)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])
