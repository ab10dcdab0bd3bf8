"""In-memory searcher (``uvaia legacy``, src/uvaia.c) on PyTorch — the
counterpart of ``uvaia_tpu/engine/legacy.py`` for one device.

The reference DB may be a FASTA file or an ingested store directory
(io/store.py) — the store path skips xz decode and host encoding, QC
runs vectorised on the stored codes with identical thresholds.

Loads the whole aligned reference DB and the queries, computes for
every (query, reference) pair the legacy counters (utils.c:50-79) on
the device (ops/distance.legacy_scores), and reproduces the three-stage
best-reference selection + stdout score table of describe_scores
(utils.c:87-161):

  stage 1: rank all refs by ACGT matches, take nbest (+ties <= nmax)
  stage 2 (n>16): re-rank the top n/8 of stage 1 by the proportion of
           char matches among valid sites, take nbest (+ties)
  stage 3 (n>32): re-rank the top n/16 by IUPAC-weighted partial
           matches, take nbest (+ties)
  output: the union, de-duplicated by frequency, printed in ACGT-match
           order; optionally the chosen references saved to xz.

The weighted partial match uses |intersection|/(|set1|*|set2|) by
default; ``--partial-rule product|jaccard|max``
(LegacyConfig.partial_rule) switches the entries between two ambiguity
codes, which are conjecture (see uvaia_tpu/engine/legacy.py).  The
integer counters equal the JAX package's; the weighted partial is the
exactly summed value rounded once to float32, where the JAX package
accumulates in float32: the printed ``partial_matches`` column can
differ in its third decimal where three-base codes (B, D, H, V) meet
codes they overlap (ops/distance.py), and is the same on the card and
on the CPU.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.encoding import IS_AMBIG, IS_PURE, encode
from ..io import store as store_mod
from ..io.fasta import FastaWriter, read_fasta_all
from ..ops import distance as dist_ops
from ..ops.score_kernels import full_float32_matmuls
from .nearest import resolve_device
from .query import log, qc_filter


@dataclass
class LegacyConfig:
    nbest: int = 8
    nmax: int = 0                    # 0 -> 2 * nbest
    trim: int = 0
    ambiguity: float = 0.5           # query ambiguity
    ref_ambiguity: float = 0.5
    output: str | None = None
    batch: int = 2048                # refs scored per device step
    partial_rule: str = "product"    # amb-vs-amb weighted-partial
                                     # entries: product|jaccard|max
    device: str = "cuda"             # "cuda" or "cpu"


def print_score_header():
    print(f"{'query sequence':>48}, {'reference sequence':>48}, "
          f"{'valid_sites':>13}, {'ACGT_matches':>13}, "
          f"{'prop_char_matches':>13}, {'partial_matches':>13}")


def describe_scores(qname: str, s0: np.ndarray, s1: np.ndarray,
                    s2: np.ndarray, s3: np.ndarray,
                    ref_names: list[str],
                    nbest: int, nmax: int) -> list[int]:
    """Three-stage selection; prints table rows; returns chosen ids.

    s0 ACGT matches, s1 text matches, s3 valid pairs (integer arrays —
    stored uint16 so the (R, Q) score store is 10 bytes/pair instead
    of 16); s2 weighted partial matches (float32)."""
    n = s0.shape[0]
    # per-query int64 views: negation/subtraction on the uint16 store
    # would wrap (transient 8R bytes, vs 16R/query held before)
    s0 = s0.astype(np.int64)
    prop = s1 / np.maximum(s3.astype(np.float64), 1e-9)
    nbest = min(nbest, n)
    nmax = min(nmax, n)

    def take(order, key, nb, nm):
        out = list(order[:nb])
        best = key[order[0]]
        i = nb
        while i < nm and best - key[order[i]] < 1e-15:
            out.append(order[i])
            i += 1
        return out

    order1 = np.lexsort((np.arange(n), -s0))
    idbest = take(order1, s0, nbest, nmax)

    if n > 16:
        cand = order1[: n // 8]
        o2 = cand[np.lexsort((np.arange(len(cand)), -prop[cand]))]
        idbest += take(o2, prop, min(nbest, len(o2)), min(nmax, len(o2)))
    if n > 32:
        cand = order1[: n // 16]
        o3 = cand[np.lexsort((np.arange(len(cand)), -s2[cand]))]
        idbest += take(o3, s2, min(nbest, len(o3)), min(nmax, len(o3)))

    uniq, counts = np.unique(idbest, return_counts=True)
    show = uniq[np.lexsort((uniq, -s0[uniq]))]
    for i in show:
        print(f"{qname:>48}, {ref_names[i]:>48}, {s3[i]:13.0f}, "
              f"{s0[i]:13.1f}, {prop[i]:13.8f}, {s2[i]:13.3f}")
    sys.stdout.flush()
    return [int(i) for i in uniq]


# the counters run as float32 matmuls, exact only in full float32
# precision (ops/distance.exact_dot)
@full_float32_matmuls()
def run_legacy(ref_path: str, query_path: str, cfg: LegacyConfig):
    dev = resolve_device(cfg.device)
    t0 = time.time()
    cfg.nbest = max(cfg.nbest, 1)
    if cfg.nmax < cfg.nbest:
        cfg.nmax = 2 * cfg.nbest
    cfg.ambiguity = min(max(cfg.ambiguity, 0.001), 1.0)
    cfg.ref_ambiguity = min(max(cfg.ref_ambiguity, 0.001), 1.0)

    st = store_mod.Store(ref_path) if store_mod.is_store(ref_path) \
        else None
    if st is not None:
        # ingested-store input: QC straight on the stored codes (same
        # thresholds as qc_filter == utils.c:11-48, vectorised; rows
        # are aligned by construction), zero decode / re-encode
        L = st.n_sites
        keep_rows: list[int] = []
        for r0 in range(0, st.n_rows, 4096):
            nb = min(4096, st.n_rows - r0)
            codes = st.codes_rows(range(r0, r0 + nb))
            acgt = IS_PURE[codes].sum(axis=1) / L
            other = 1.0 - acgt - IS_AMBIG[codes].sum(axis=1) / L
            keep = ((L >= 5) & (other <= cfg.ref_ambiguity)
                    & (acgt >= 1.0 - 1.1 * cfg.ref_ambiguity))
            keep_rows.extend(int(r0 + j) for j in np.nonzero(keep)[0])
            # Python work proportional to REJECTS (rare), not rows —
            # only dropped rows need their qc_filter-wording log line
            for j in np.nonzero(~keep)[0]:
                if L < 5:
                    log(f"Sequence {st.name(r0 + j)} is too short ( = "
                        f"{L} sites), limit is hardcoded at 5bps.")
                elif other[j] > cfg.ref_ambiguity:
                    log(f"Sequence {st.name(r0 + j)} has proportion of "
                        f"N etc. (={other[j]:f}) above threshold of "
                        f"{cfg.ref_ambiguity:f}")
                else:
                    log(f"Sequence {st.name(r0 + j)} has proportion of "
                        f"ACGT (={acgt[j]:f}) below threshold of "
                        f"{1.0 - 1.1 * cfg.ref_ambiguity:f}")
        rnames = [st.name(r) for r in keep_rows]
        rseqs = None
    else:
        refs = read_fasta_all(ref_path)
        rnames, rseqs = qc_filter([r.name for r in refs],
                                  [r.seq for r in refs],
                                  cfg.ref_ambiguity, check_aligned=True)
    log(f"Reference database: {len(rnames)} valid sequences "
        f"({time.time()-t0:.2f}s)")
    if not rnames:
        raise SystemExit(f"No valid reference sequences in {ref_path}.")
    if st is None:
        L = len(rseqs[0])

    queries = read_fasta_all(query_path)
    qnames, qseqs = qc_filter([q.name for q in queries],
                              [q.seq for q in queries],
                              cfg.ambiguity, check_aligned=False)
    keep = [(n, s) for n, s in zip(qnames, qseqs) if len(s) == L]
    for n, s in zip(qnames, qseqs):
        if len(s) != L:
            log(f"this program assumes aligned sequences, and sequence "
                f"{n} has length {len(s)} while references have {L}")
    if not keep:
        raise SystemExit("No valid query sequences.")
    qnames = [n for n, _ in keep]
    q_codes = np.stack([encode(s) for n, s in keep])

    trim = max(0, min(cfg.trim, int(L / 2.1)))
    qdata = dist_ops.build_legacy_query_data(
        q_codes, trim, partial_rule=cfg.partial_rule, device=dev)

    # score all refs in device batches.  The (R, Q) store is compact:
    # the integer counters live as uint16 when L permits, only
    # the weighted partial stays float32 — 10 bytes/pair instead of 16
    # (the selection semantics need all refs per query, so the store
    # itself is inherent to this in-memory tool, as in uvaia.c:140).
    R, Q = len(rnames), len(qnames)
    # counters fit uint16 only when L < 2^16; longer alignments (e.g.
    # bacterial cores) fall back to int32 so nothing wraps mod 65536
    int_dtype = np.uint16 if L < 2 ** 16 else np.int32
    store_gb = R * Q * (3 * np.dtype(int_dtype).itemsize + 4) / 2 ** 30
    if store_gb > 4.0:
        log(f"WARNING: the in-memory score store for {R} references x "
            f"{Q} queries needs ~{store_gb:.1f} GB of host RAM (this "
            f"tool keeps every pair's scores, as uvaia.c does; use "
            f"`nearest` for large databases)")
    all_s0 = np.zeros((R, Q), dtype=int_dtype)
    all_s1 = np.zeros((R, Q), dtype=int_dtype)
    all_s2 = np.zeros((R, Q), dtype=np.float32)
    all_s3 = np.zeros((R, Q), dtype=int_dtype)
    for start in range(0, R, cfg.batch):
        if st is not None:
            codes = st.codes_rows(keep_rows[start:start + cfg.batch])
        else:
            codes = np.stack([encode(s)
                              for s in rseqs[start:start + cfg.batch]])
        s = dist_ops.legacy_scores(
            qdata, torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        ).cpu().numpy()
        sl = slice(start, start + codes.shape[0])
        all_s0[sl] = s[..., 0]
        all_s1[sl] = s[..., 1]
        all_s2[sl] = s[..., 2]
        all_s3[sl] = s[..., 3]

    print_score_header()
    chosen: list[int] = []
    for qi, qname in enumerate(qnames):
        chosen += describe_scores(qname, all_s0[:, qi], all_s1[:, qi],
                                  all_s2[:, qi], all_s3[:, qi], rnames,
                                  cfg.nbest, cfg.nmax)
    log(f"finished search in {time.time()-t0:.3f} secs")

    if cfg.output:
        ids = sorted(set(chosen))
        path = cfg.output
        if not path.endswith(".xz"):
            path += ".fa.xz"
        with FastaWriter(path) as w:
            for i in ids:
                w.write(rnames[i], st.seq_row(keep_rows[i])
                        if st is not None else rseqs[i])
        log(f"Saved {len(ids)} sequences to {path}")
    return (all_s0, all_s1, all_s2, all_s3), qnames, rnames
