"""The benchmark's one traffic generator: SARS-CoV-2-like genomes from a
lineage tree, as aligned rows (the `nearest` database and queries) or as
raw assemblies (the `align` queries).

Every traffic mix is a JSON file beside this module, which names the
public source of each parameter (``sources``); this module reads the
parameters and draws everything from the run's seed, so the same seed
gives the same genomes, byte for byte.

Rewritten from the generators of ``chip_smoke.py`` at commit 0e5ecf2
(``make_genomes``, ``query_set``, ``mutate``, ``align_queries``), which
probe edge cases (every reference derived from a query, one far row,
hand-placed probe records); here every genome comes from one lineage
model:

* a backbone of the configuration's length and base composition;
* ``founders`` lineage founders, their SNP counts from the backbone
  spread evenly over ``founder_snps``, each with ``indels`` of its own
  (lineage-defining in-frame deletions and insertions, which every
  genome of the lineage carries);
* lineage sizes Zipf-skewed with exponent ``zipf_s``: a batch of n
  genomes holds round(n x weight) of each lineage, in an order drawn
  from the seed;
* each genome its founder plus Poisson(``private_snps``) SNPs,
  ``ambiguity`` IUPAC codes and ``dropouts`` runs of N (amplicon
  dropouts, ``dropout_len`` long);
* the sites no amplicon covers N-masked at the ends (``mask_5prime``,
  ``mask_3prime``);
* an assembly is such a genome in its own coordinates: its lineage's
  indels applied and, with ``strip_n_ends``, its leading and trailing
  Ns removed.

Imports numpy alone.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AMBIG = np.frombuffer(b"RYKMSWBDHV", dtype=np.uint8)
N = ord("N")
_BASE_INDEX = np.full(256, 255, dtype=np.uint8)
_BASE_INDEX[ACGT] = np.arange(4, dtype=np.uint8)

# named random streams, so one part of the data never shifts another
STREAM_TREE, STREAM_DATABASE, STREAM_SAMPLE, STREAM_WARMUP = 1, 2, 3, 4
STREAM_JOB0 = 1000


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for (seed, stream); any seed up to 2**64."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def load_mix(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _span(rng, lo_hi, size=None):
    """Integers uniform in the closed range [lo, hi]."""
    lo, hi = lo_hi
    return rng.integers(lo, hi + 1, size)


class LineageTree:
    """The backbone and its founders (letters, uint8).

    The sizes (each founder's SNP count and lineage weight) are the
    same for every seed; the seed draws the bases, the SNP positions and
    every genome's own changes, so that runs of different seeds do the
    same amount of work."""

    def __init__(self, seed: int, length: int, composition: dict,
                 lineages: dict):
        rng = rng_for(seed, STREAM_TREE)
        p = np.array([composition[b] for b in "ACGT"], dtype=np.float64)
        self.backbone = ACGT[rng.choice(4, size=length, p=p / p.sum())]
        n = lineages["founders"]
        lo, hi = lineages["founder_snps"]
        # SNP counts paired with the Zipf ranks in one fixed order
        counts = np.rint(np.linspace(lo, hi, n)).astype(np.int64)
        counts = np.random.default_rng(0).permutation(counts)
        self.founders = np.repeat(self.backbone[None, :], n, axis=0)
        for f in range(n):
            pos = rng.choice(length, size=int(counts[f]), replace=False)
            self.founders[f, pos] = _substitute(rng, self.founders[f, pos])
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** lineages["zipf_s"]
        self.weights = w / w.sum()
        self.indels = self._indels(rng, length, n, lineages.get("indels"))

    @staticmethod
    def _indels(rng, length: int, n: int, spec) -> list[list]:
        """Each founder's indels, [(position, deleted, inserted bytes)],
        in descending position.  Counts, lengths and kinds come from a
        fixed stream (the same for every seed); the seed draws the
        positions and the inserted bases."""
        out: list[list] = [[] for _ in range(n)]
        if not spec:
            return out
        fixed = np.random.default_rng(1)
        lo, hi = spec["count"]
        counts = fixed.permutation(np.rint(np.linspace(lo, hi, n))
                                   .astype(np.int64))
        for f in range(n):
            k = int(counts[f])
            lens = fixed.choice(spec["len"], size=k)
            ins = fixed.random(k) < spec["insertion_share"]
            pos = rng.integers(0, length, k)
            for p, ln, is_ins in sorted(zip(pos, lens, ins), reverse=True):
                ln = int(ln)
                if is_ins:
                    out[f].append((int(p), 0,
                                   ACGT[rng.integers(0, 4, ln)].tobytes()))
                else:
                    out[f].append((int(p), ln, b""))
        return out

    def lineages_of(self, rng, n: int) -> np.ndarray:
        """n lineage labels: round(n x weight) of each (largest
        remainders), in an order drawn from the seed."""
        exact = n * self.weights
        counts = np.floor(exact).astype(np.int64)
        extra = np.argsort(-(exact - counts), kind="stable")[:n - counts.sum()]
        counts[extra] += 1
        return rng.permutation(np.repeat(np.arange(len(counts)), counts))

    @property
    def length(self) -> int:
        return self.backbone.shape[0]


def _substitute(rng, letters: np.ndarray) -> np.ndarray:
    """Each base replaced by one of the three other bases."""
    idx = _BASE_INDEX[letters].astype(np.int64)
    shift = rng.integers(1, 4, letters.shape[0])
    out = ACGT[(idx + shift) % 4]
    keep = idx == 255                       # not a base: left as it is
    out[keep] = letters[keep]
    return out


def genomes(rng, tree: LineageTree, n: int, genome: dict):
    """((n, L) letters, (n,) lineages): founder + private SNPs +
    ambiguity codes + dropout runs of N."""
    L = tree.length
    lineage = tree.lineages_of(rng, n)
    out = tree.founders[lineage]
    counts = rng.poisson(genome["private_snps"], n)
    rows = np.repeat(np.arange(n), counts)
    pos = rng.integers(0, L, rows.shape[0])
    out[rows, pos] = _substitute(rng, out[rows, pos])
    counts = _span(rng, genome["ambiguity"], n)
    rows = np.repeat(np.arange(n), counts)
    pos = rng.integers(0, L, rows.shape[0])
    out[rows, pos] = AMBIG[rng.integers(0, len(AMBIG), rows.shape[0])]
    runs = _span(rng, genome["dropouts"], n)
    for r in np.nonzero(runs)[0]:
        for _ in range(runs[r]):
            ln = int(_span(rng, genome["dropout_len"]))
            s = int(rng.integers(0, L - ln))
            out[r, s:s + ln] = N
    return out, lineage


def _mask_ends(rng, out: np.ndarray, mix: dict) -> None:
    out[:, :mix["mask_5prime"]] = N
    tails = _span(rng, mix["mask_3prime"], out.shape[0])
    for r in range(out.shape[0]):
        out[r, out.shape[1] - tails[r]:] = N


def aligned_rows(rng, tree: LineageTree, n: int, mix: dict) -> np.ndarray:
    """(n, L) aligned genomes with N-masked ends."""
    out, _ = genomes(rng, tree, n, mix["genome"])
    _mask_ends(rng, out, mix)
    return out


def assemblies(rng, tree: LineageTree, n: int, mix: dict) -> list[bytes]:
    """n raw assemblies: genomes with N-masked ends in their own
    coordinates (their lineage's indels applied) and, with
    ``strip_n_ends``, the leading and trailing Ns removed."""
    rows, lineage = genomes(rng, tree, n, mix["genome"])
    _mask_ends(rng, rows, mix)
    out = []
    for r in range(n):
        q = bytearray(rows[r].tobytes())
        for pos, deleted, inserted in tree.indels[lineage[r]]:
            q[pos:pos + deleted] = inserted
        q = bytes(q)
        if mix.get("strip_n_ends"):
            q = q.strip(b"N")
        out.append(q)
    return out


def fasta_bytes(names, rows) -> bytes:
    """FASTA text, one line a sequence."""
    return b"".join(b">%s\n%s\n" % (nm.encode(), r if isinstance(r, bytes)
                                     else r.tobytes())
                    for nm, r in zip(names, rows))


def write_fasta(path: Path, names, rows, chunk: int = 2048) -> None:
    with open(path, "wb") as fh:
        for i in range(0, len(names), chunk):
            fh.write(fasta_bytes(names[i:i + chunk], rows[i:i + chunk]))
