"""One-pass canopy clustering / dedup (``uvaia cluster``) on PyTorch —
the counterpart of ``uvaia_tpu/engine/cluster.py`` for one device.

Capability match for src/cluster.c + the cluster primitives in
fastaseq.c:95-293: stream alignments, group sequences whose pairwise
text-mismatch distance is <= `distance`, keep one medoid per cluster
(the most resolved member, add_seq_to_cluster fastaseq.c:182), record
every member name, and write the medoid alignment + membership table.

The same reformulation as the JAX package (documented deviations from
the C design, which is itself order-dependent and approximate):

* the C pool of per-thread queues + log2 merge reduction
  (cluster.c:219-230) becomes ONE global cluster set scanned densely:
  each batch computes exact mismatch distances to ALL current medoids
  (15 int8 features a site: valid + pure-base one-hot + ambiguity-code
  one-hot close the text-match count exactly), then a final all-pairs
  medoid merge pass replaces the queue merges;
* the C distance-to-reference "ring" prefilter (fastaseq.c:154) is not
  needed — distances are computed exactly for all pairs;
* within a batch, sequences join clusters by batch-start medoids.

On the device: a batch arrives as a sparse delta (rebuilt by
ops/scan.reconstruct_delta at the width L: on a CUDA device the
hand-written kernel of csrc/recon.cu) or as 4-bit packed codes, against
the reference codes (FASTA input) or the store's own base (store
input).  The distances are one int8 product a medoid tile,
``torch._int_mm`` with int32 accumulation (the JAX package's XLA
``dot_general``, no Pallas kernel): exact, as no sum exceeds L.  The
device is explicit (``ClusterConfig.device``): a missing GPU is an
error, never a silent CPU run.

Reference sequence: first sequence of -r, or a consensus built from
the first <=1024 database sequences with N fill-in and final N->A
(read_reference_sequence cluster.c:260-277, fastaseq.c:488-520).
Medoid distance-to-reference is reported like quick_pairwise_score_
reference (valid-pair char mismatches over the trim window).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.encoding import IS_PURE, encode
from ..io import store as store_mod
from ..io.compress import open_write
from ..io.fasta import WRITE_CODEC_SUFFIX, make_fasta_writer, read_fasta
from ..ops.host import delta_encode, pack_codes
from ..ops.scan import reconstruct_delta, unpack_codes, upload
from .nearest import resolve_device
from .query import log
from .stream import RefStreamer


@dataclass
class ClusterConfig:
    distance: int = 1
    trim: int = 0
    pool: int = 1024              # sequences per device batch
    snps: int = 1                 # SNP positions tracked (sort tiebreak)
    reference: str | None = None
    output: str | None = None
    medoid_capacity: int = 1 << 17
    print_interval: int = 5000
    save_interval: float = 30.0   # secs between partial table saves
                                  # (cluster.c:197-200 resilience)
    codec: str = "xz"             # output compression: xz/bz2/gz/raw
    device: str = "cuda"          # "cuda" (kernels) or "cpu" (plain)

    @property
    def prefix(self) -> str:
        return self.output if self.output else "cluster_uvaia"


@dataclass
class Cluster:
    name: str
    seq: bytes
    non_n: int
    dist_ref: int
    snp_pos: tuple      # positions of the first -s SNPs vs the reference
                        # (sort tiebreak, quick_pairwise_score_reference
                        # fastaseq.c:522-537)
    neighbours: list[str] = field(default_factory=list)


def _ref_seqs(path: str):
    """Sequence bytes from a FASTA file or an ingested store (stores
    decode rows exactly — io/store.py seq_row)."""
    if store_mod.is_store(path):
        st = store_mod.Store(path)
        for r in range(st.n_rows):
            yield st.seq_row(r)
    else:
        for rec in read_fasta(path):
            yield rec.seq


def build_reference(path: str, max_seqs: int) -> tuple[bytes, int]:
    """Consensus reference from up to max_seqs sequences: start with the
    first (non-ACGT -> N), fill Ns from later ACGT, then N -> A."""
    ref = None
    count = 0
    L = 0
    for seq in _ref_seqs(path):
        codes = encode(seq)
        acgt = IS_PURE[codes] != 0
        arr = np.frombuffer(seq, dtype=np.uint8).copy()
        arr[~acgt] = ord("N")
        if ref is None:
            ref = arr
            L = len(arr)
        else:
            if len(arr) != L:
                raise SystemExit("cluster: sequences are not aligned")
            fill = (ref == ord("N")) & acgt
            ref[fill] = arr[fill]
        count += 1
        if count >= max_seqs:
            break
    if ref is None:
        raise SystemExit(f"No sequences found in {path}")
    ref[ref == ord("N")] = ord("A")
    return ref.tobytes(), L


# ----------------------------------------------------------------------
# exact text-mismatch distances as one int8 product

#: the ambiguity codes with a one-hot plane of their own (15, all four
#: bits, has none: two 15s never count as a text match)
AMB_CODES = (3, 5, 6, 7, 9, 10, 11, 12, 13, 14)
N_PLANES = 15


def plane_table() -> np.ndarray:
    """(16, 15) int8: row c holds code c's features — [c != 0], the four
    pure-base one-hot planes (pop(c) == 1) and the ten ambiguity-code
    one-hot planes, as uvaia_tpu's ``MedoidIndex`` builds them."""
    t = np.zeros((16, N_PLANES), dtype=np.int8)
    for c in range(1, 16):
        t[c, 0] = 1
        if bin(c).count("1") == 1:
            t[c, c.bit_length()] = 1
        elif c in AMB_CODES:
            t[c, 5 + AMB_CODES.index(c)] = 1
    return t


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (N, K) int8 -> (M, N) int32, exact (int32 accumulation),
    through torch._int_mm on either device.  Its CUDA form needs M > 16
    and K, N multiples of 8: the callers pad rows and sites with code
    0, which has no feature and adds nothing."""
    return torch._int_mm(a, b.t())


class MedoidIndex:
    """Device-resident medoid code matrix + exact mismatch distances."""

    STORE_TILE = 4096       # medoid rows per distance tile (bounds the
                            # (tile, 15 L) int8 feature planes)

    def __init__(self, L: int, capacity: int, trim: int,
                 initial_tier: int = 1024,
                 delta_base: np.ndarray | None = None,
                 stats_ref: np.ndarray | None = None, n_snps: int = 1,
                 device="cpu"):
        self.device = torch.device(device)
        self.L = L
        self.trim = trim
        self.capacity = capacity
        self.n = 0
        self._delta_base = delta_base          # host copy for encoding
        self._delta_base_d = (None if delta_base is None
                              else self._up(delta_base))
        # comparison reference for per-row stats (non_n / dist_ref /
        # first-n_snps SNP positions), folded into assign: the batch
        # codes are on the device there anyway
        self._stats_ref_d = (None if stats_ref is None
                             else self._up(stats_ref))
        self._n_snps = max(0, int(n_snps))
        # store sized in x4 tiers, as in the JAX package
        self.tier = initial_tier
        self._codes = torch.zeros((self.tier, L), dtype=torch.uint8,
                                  device=self.device)
        window = np.zeros(L, dtype=bool)
        window[trim:L - trim if trim else L] = True
        self._window = self._up(window)
        # sites padded to a multiple of 8 (K = 15 * Lp, _int_mm's rule)
        self._Lp = _round_up(L, 8)
        table = plane_table()
        sign = np.array([1] + [-1] * (N_PLANES - 1), dtype=np.int8)
        self._table = self._up(table)
        self._table_neg = self._up(table * sign)

    def _up(self, x: np.ndarray) -> torch.Tensor:
        return upload(np.asarray(x), self.device)

    def planes(self, codes: torch.Tensor, rows: int,
               signed: bool = False) -> torch.Tensor:
        """(rows, 15 * Lp) int8 feature planes of (n, L) uint8 codes,
        windowed by `trim`; rows past n and sites past L are code 0.
        ``signed`` negates the 14 one-hot planes, so that the product
        of plain and signed planes is valid pairs - text matches."""
        c = torch.where(self._window[None, :], codes, 0)
        c = torch.nn.functional.pad(
            c, (0, self._Lp - self.L, 0, rows - c.shape[0]))
        table = self._table_neg if signed else self._table
        return table.index_select(0, c.reshape(-1).to(torch.int32)) \
            .reshape(rows, self._Lp * N_PLANES)

    def _dists_from(self, batch_planes: torch.Tensor,
                    other: torch.Tensor) -> torch.Tensor:
        """(len(batch_planes), round_up(n, 8)) int32 distances of the
        batch to the (n, L) code rows `other` (the rows past n read 0
        mismatches: slice them off)."""
        return int8_product(batch_planes, self.planes(
            other, _round_up(other.shape[0], 8), signed=True))

    def dists(self, batch_codes: torch.Tensor,
              med_codes: torch.Tensor) -> torch.Tensor:
        """(B, M) int32 valid - text_matches: the JAX package's
        ``MedoidIndex._dist_expr`` on two code tensors."""
        B, M = batch_codes.shape[0], med_codes.shape[0]
        pb = self.planes(batch_codes, max(24, _round_up(B, 8)))
        return self._dists_from(pb, med_codes)[:B, :M]

    def _grow(self, need: int) -> None:
        if need > self.capacity:
            raise SystemExit("cluster: medoid capacity exceeded; raise "
                             "--medoid-capacity")
        while need > self.tier:
            pad = torch.zeros((3 * self.tier, self.L), dtype=torch.uint8,
                              device=self.device)
            self.tier *= 4
            self._codes = torch.cat([self._codes, pad], dim=0)

    def apply_updates(self, codes_d: torch.Tensor,
                      replacements: dict[int, int],
                      new_rows: list[int]) -> None:
        """Medoid store maintenance for one batch, in ONE copy:
        ``replacements`` maps store row -> batch row (last writer per
        store row, matching the sequential semantics), ``new_rows``
        appends batch rows as fresh medoids in order.  ``codes_d`` is
        the (B, L) device codes returned by assign."""
        k_new = len(new_rows)
        if not replacements and not k_new:
            return
        self._grow(self.n + k_new)
        dst = list(replacements.keys()) + [self.n + i
                                           for i in range(k_new)]
        src = list(replacements.values()) + list(new_rows)
        idx = lambda v: torch.tensor(v, dtype=torch.int64,
                                     device=self.device)
        self._codes.index_copy_(0, idx(dst), codes_d.index_select(0, idx(src)))
        self.n += k_new

    def _batch_codes(self, codes, ok, payload, base_d) -> torch.Tensor:
        """(B, L) uint8 codes of the batch on the device: the payload
        (store input: a delta pre-encoded against `base_d`, the store's
        base, or packed rows) or the host codes, delta-encoded against
        the index's own base (or packed when the diffs overflow)."""
        base = base_d if base_d is not None else self._delta_base_d
        if payload is None:
            enc = delta_encode(codes, ok, self._delta_base)
            payload = (("delta", *enc) if enc is not None
                       else ("packed", pack_codes(codes)))
            base = self._delta_base_d
        if payload[0] == "delta":
            return reconstruct_delta(base, self._up(payload[1]),
                                     self._up(payload[2]))
        return unpack_codes(self._up(payload[1]), self.L).contiguous()

    def assign(self, codes: np.ndarray | None, ok: np.ndarray,
               distance: int, payload=None, base_d=None):
        """Fused batch step; only O(B) + O(B^2) bool leaves the device,
        never the (B, M) distance matrix.

        `payload` (store input): a StoreStreamer payload — ("delta",
        pos, val) PRE-encoded against `base_d` (the streamer's base, on
        the device) or ("packed", pk) — uploaded as-is; `codes`/`ok` are
        ignored then and may be None.

        Returns (first_hit (B,) int32 — lowest medoid index within
        `distance`, -1 if none; self_mask (B, B) bool — within-batch
        pairs within `distance`); when the index was built with
        `stats_ref`, also (non_n (B,) int32, dist_ref (B,) int32, snp
        (B, n_snps) int32 — first SNP positions vs stats_ref, -1
        padded), matching _seq_stats exactly; and last the (B, L) uint8
        batch codes AS A DEVICE TENSOR (for medoid append/replace)."""
        codes_d = self._batch_codes(codes, ok, payload, base_d)
        B = codes_d.shape[0]
        pb = self.planes(codes_d, max(24, _round_up(B, 8)))
        big = 2**31 - 1
        first = torch.full((B,), big, dtype=torch.int64,
                           device=self.device)
        # medoid rows [0, n) in tiles, the first tile with a hit wins
        # (tiles ascend); the signed planes of one tile at a time
        for t0 in range(0, self.n, self.STORE_TILE):
            t1 = min(self.n, t0 + self.STORE_TILE)
            hit = self._dists_from(pb, self._codes[t0:t1])[:B, :t1 - t0] \
                <= distance
            col = hit.to(torch.uint8).argmax(dim=1) + t0
            first = torch.where(hit.any(dim=1) & (first == big), col, first)
        first = torch.where(first < big, first, -1).to(torch.int32)
        d_self = self._dists_from(pb, codes_d)[:B, :B] <= distance
        out = [first, d_self]
        if self._stats_ref_d is not None:
            # per-row stats vs the comparison reference
            # (quick_pairwise_score_reference fastaseq.c:522-537
            # semantics, == the host _seq_stats definition): non_n is
            # unwindowed; mismatches are valid-pair, windowed
            v = codes_d != 0
            non_n = v.sum(dim=1, dtype=torch.int32)
            rvalid = (self._stats_ref_d != 0) & self._window
            m = v & rvalid[None, :] & (codes_d != self._stats_ref_d[None, :])
            dist_ref = m.sum(dim=1, dtype=torch.int32)
            cols = torch.arange(self.L, device=self.device)
            snps = []
            for _ in range(self._n_snps):
                p = torch.where(m.any(dim=1),
                                m.to(torch.uint8).argmax(dim=1), -1)
                snps.append(p.to(torch.int32))
                m = m & (cols[None, :] > p[:, None])
            snp = (torch.stack(snps, dim=1) if snps else
                   torch.zeros((B, 0), dtype=torch.int32,
                               device=self.device))
            out += [non_n, dist_ref, snp]
        return tuple(o.cpu().numpy() for o in out) + (codes_d,)

    def close_vs(self, rows: torch.Tensor, distance: int) -> np.ndarray:
        """(len(rows), n) bool: exact mismatch distance of the (r, L)
        device code rows to every medoid within `distance` (the blocked
        final merge; only the boolean mask leaves the device), the
        medoids in tiles as in assign."""
        R = rows.shape[0]
        pr = self.planes(rows, max(24, _round_up(R, 8)))
        masks = [self._dists_from(pr, self._codes[t0:min(
                     self.n, t0 + self.STORE_TILE)])[:R, :min(
                     self.n - t0, self.STORE_TILE)] <= distance
                 for t0 in range(0, self.n, self.STORE_TILE)]
        if not masks:
            return np.zeros((R, 0), dtype=bool)
        return torch.cat(masks, dim=1).cpu().numpy()

    def append(self, rows: np.ndarray) -> None:
        self._grow(self.n + rows.shape[0])
        self._codes[self.n:self.n + rows.shape[0]] = self._up(rows)
        self.n += rows.shape[0]

    def replace(self, index: int, row: np.ndarray) -> None:
        self._codes[index] = self._up(row)


def _seq_stats(codes: np.ndarray, ref_codes: np.ndarray, window: np.ndarray,
               n_snps: int):
    """(non_n, dist_ref, first-n_snps SNP positions) per row, as in
    quick_pairwise_score_reference (fastaseq.c:522-537).

    Host numpy SPEC of the stats MedoidIndex.assign computes on the
    device (kept as the oracle the equivalence test pins against; the
    engine itself uses the device fold)."""
    valid = codes != 0
    non_n = valid.sum(axis=1).astype(np.int64)
    vpair = valid & (ref_codes != 0)[None, :] & window[None, :]
    mism = vpair & (codes != ref_codes[None, :])
    dist_ref = mism.sum(axis=1).astype(np.int64)
    snp_pos = []
    for row in mism:
        pos = np.flatnonzero(row)[:max(n_snps, 0)]
        snp_pos.append(tuple(int(p) for p in pos)
                       + (-1,) * (n_snps - len(pos)))
    return non_n, dist_ref, snp_pos


def run_cluster(fasta_paths: list[str], cfg: ClusterConfig):
    dev = resolve_device(cfg.device)
    csv_suffix = WRITE_CODEC_SUFFIX[cfg.codec]
    csv_path = cfg.prefix + ".csv" + csv_suffix
    t0 = time.time()
    if cfg.reference:
        ref_seq, L = build_reference(cfg.reference, 1)
    else:
        ref_seq, L = build_reference(fasta_paths[0], 1024)
    ref_codes = encode(ref_seq)
    window = np.zeros(L, dtype=bool)
    trim = max(0, min(cfg.trim, int(L / 2.1)))
    window[trim:L - trim if trim else L] = True
    log(f"Clustering with distance {cfg.distance}, reference of {L} sites")

    index = MedoidIndex(L, cfg.medoid_capacity, trim,
                        delta_base=ref_codes,
                        stats_ref=ref_codes, n_snps=cfg.snps, device=dev)
    clusters: list[Cluster] = []
    last_print = 0

    def process(batch, payload=None, base_d=None):
        n = batch.n
        # fused device step: first-hit medoid + within-batch proximity
        # mask + per-row reference stats.  Store input hands the
        # streamer's pre-encoded payload straight through; medoid rows
        # are gathered from the returned DEVICE codes.
        d_first, d_self, non_n, dist_ref, snp, codes_d = index.assign(
            None if payload is not None else batch.codes,
            batch.ok, cfg.distance, payload=payload, base_d=base_d)
        first = [tuple(int(p) for p in row) for row in snp[:n]]
        new_rows: list[int] = []                     # batch rows that
        new_cl: list[int] = []                       # ...opened clusters
        repl: dict[int, int] = {}                    # store row -> batch
                                                     # row (last wins)
        for b in range(n):
            target = int(d_first[b])
            if target < 0:
                for nb, ci in zip(new_rows, new_cl):  # chain within batch
                    if d_self[b, nb]:
                        target = ci
                        break
            if target < 0:
                clusters.append(Cluster(batch.names[b], batch.seq(b),
                                        int(non_n[b]),
                                        int(dist_ref[b]), first[b]))
                new_rows.append(b)
                new_cl.append(len(clusters) - 1)
            else:
                cl = clusters[target]
                if non_n[b] > cl.non_n:              # new, more-resolved medoid
                    cl.neighbours.append(cl.name)
                    cl.name, cl.seq = batch.names[b], batch.seq(b)
                    cl.non_n = int(non_n[b])
                    cl.dist_ref = int(dist_ref[b])
                    cl.snp_pos = first[b]
                    if target < index.n:             # in-store medoid
                        repl[target] = b
                    else:                            # opened this batch
                        new_rows[new_cl.index(target)] = b
                else:
                    cl.neighbours.append(batch.names[b])
        # ONE device copy per batch covers every replacement and append,
        # gathered from the step's device codes
        index.apply_updates(codes_d, repl, new_rows)

    def save_partial(n_seen: int) -> None:
        """Crash-resilient partial membership table, written atomically
        to the final csv path (save_neighbours_to_xz_file semantics,
        cluster.c:197-200: a killed run keeps a usable table)."""
        # keep the real .csv.<codec> suffix INSIDE the temp name:
        # open_write picks the codec by suffix, so '…csv.xz.part'
        # would be written uncompressed and renamed to an unreadable
        # .csv.xz
        tmp = cfg.prefix + ".part.csv" + csv_suffix
        with open_write(tmp) as fh:
            for c in clusters:
                fh.write((",".join([c.name] + c.neighbours) + "\n")
                         .encode())
        import os as _os
        _os.replace(tmp, csv_path)
        log(f"Saving partial clustering info from {n_seen} sequences "
            f"to file {csv_path}")

    n_store = sum(store_mod.is_store(p) for p in fasta_paths)
    if n_store and n_store != len(fasta_paths):
        raise SystemExit(
            "cluster: inputs mix ingested stores and FASTA files; "
            "ingest all inputs or none")
    if n_store:
        # decode-free input: the streamer's payloads (delta vs ITS
        # base, or packed rows) go straight to the device; medoid seqs
        # decode on demand (seq_row)
        streamer = store_mod.StoreStreamer(fasta_paths, L, cfg.pool,
                                           ref_ambiguity=1.0)
        sbase_d = (None if streamer.base is None
                   else upload(streamer.base, dev))
        pairs = ((b, pl, sbase_d) for b, pl in streamer)
    else:
        streamer = RefStreamer(fasta_paths, L, cfg.pool,
                               ref_ambiguity=1.0)
        pairs = ((b, None, None) for b in streamer)
    last_save = time.time()
    for batch, payload, base_d in pairs:
        process(batch, payload, base_d)
        count = batch.base_idx + batch.n
        if count - last_print >= cfg.print_interval:
            last_print = count
            log(f"{count} sequences analysed in total; "
                f"{len(clusters)} clusters; "
                f"{time.time()-t0:.3f} secs elapsed")
        if time.time() - last_save >= cfg.save_interval:
            save_partial(count)
            last_save = time.time()
    count = streamer.stats.count

    # final all-pairs medoid merge (replaces cluster.c:219-230 reduction)
    merged = _merge_clusters(index, clusters, cfg.distance)
    log(f"{count} sequences -> {len(merged)} clusters after merge "
        f"({time.time()-t0:.3f}s)")

    # compare_fastaseq order (fastaseq.c:23-40): member count, then
    # dist-to-ref, then the tracked SNP positions, then resolution
    merged.sort(key=lambda c: (-len(c.neighbours), -c.dist_ref,
                               tuple(-p for p in c.snp_pos), -c.non_n))
    with open_write(csv_path) as fh:
        for c in merged:
            fh.write((",".join([c.name] + c.neighbours) + "\n").encode())
    # medoid sets scale with the cluster count: multi-stream xz on a
    # thread pool instead of one serial stream
    with make_fasta_writer(cfg.prefix + ".aln", cfg.codec) as w:
        for c in merged:
            w.write(c.name, c.seq)
    log(f"Saved {len(merged)} medoids to {cfg.prefix}.aln{csv_suffix} "
        f"and membership to {csv_path}")
    return merged


def _merge_clusters(index: MedoidIndex, clusters: list[Cluster],
                    distance: int, block: int = 2048) -> list[Cluster]:
    """Union-find over all medoid pairs within `distance`, computed in
    (block x M) distance tiles so large runs never materialise the full
    pairwise matrix."""
    if len(clusters) < 2:
        return clusters
    M = len(clusters)
    assert M == index.n, "medoid store out of sync with cluster list"
    # the medoid store ALREADY holds these rows on the device (append /
    # replace keep it in sync: store row i == clusters[i])
    parent = list(range(M))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for start in range(0, M, block):
        rows = index._codes[start:min(start + block, M)]   # device slice
        close = index.close_vs(rows, distance)
        ii, jj = np.nonzero(close)
        for i, j in zip(ii.tolist(), jj.tolist()):
            gi = start + i
            if j <= gi:
                continue
            ri, rj = find(gi), find(j)
            if ri != rj:
                parent[max(ri, rj)] = min(ri, rj)
    groups: dict[int, list[int]] = {}
    for i in range(len(clusters)):
        groups.setdefault(find(i), []).append(i)
    out = []
    for members in groups.values():
        best = max(members, key=lambda i: clusters[i].non_n)
        cl = clusters[best]
        for i in members:
            if i == best:
                continue
            o = clusters[i]
            cl.neighbours.extend([o.name] + o.neighbours)
        out.append(cl)
    return out
