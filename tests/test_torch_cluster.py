"""`cluster` end to end: the port (uvaia_tpu_torch, on the CPU) against
the JAX package (uvaia_tpu) on the same files, at the scenarios of
tests/test_tools.py and tests/test_store.py.  The `.csv.xz` and
`.aln.xz` bytes and the returned clusters must be equal; the distance
product must equal ``MedoidIndex._dist_expr`` exactly, and the device
fold of the first hit and the per-row stats must equal their
definitions.
"""

import gzip
import lzma
import os

import jax.numpy as jnp
import numpy as np
import pytest

import uvaia_tpu.engine.cluster as jcluster
import uvaia_tpu.io.store as jstore
from uvaia_tpu.core import oracle
from uvaia_tpu.core.encoding import encode
from uvaia_tpu.ops import scan as jscan
from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.engine import cluster as pcluster
from uvaia_tpu_torch.io import store as pstore
from uvaia_tpu_torch.ops import host, recon

from test_nearest import random_seqs, write_fasta
from test_store import _mk_genomes, _write_fasta


def _key(merged):
    return [(c.name, c.neighbours, c.non_n, c.dist_ref, c.snp_pos, c.seq)
            for c in merged]


def _cluster_both(paths, suffix=".xz", port_paths=None, **kw):
    """Both packages on the same inputs: equal clusters, equal bytes."""
    jm = jcluster.run_cluster(list(paths), jcluster.ClusterConfig(
        output="jax", **kw))
    pm = pcluster.run_cluster(list(port_paths or paths),
                              pcluster.ClusterConfig(output="port",
                                                     device="cpu", **kw))
    assert _key(pm) == _key(jm)
    for ext in (".csv", ".aln"):
        port, jax = "port" + ext + suffix, "jax" + ext + suffix
        if suffix == ".gz":     # gzip stamps the time into its header
            port, jax = gzip.open(port), gzip.open(jax)
        else:
            port, jax = open(port, "rb"), open(jax, "rb")
        with port, jax:
            assert port.read() == jax.read(), ext
    return pm


def test_cluster_dedup(tmp_path, monkeypatch):
    """tests/test_tools.py:151: two groups, pool 2 (a batch below
    _int_mm's 17 rows, padded)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(31)
    L = 300
    base = random_seqs(rng, 3, L, mut=0.0)[0]

    def mut(s, positions, char="A"):
        b = bytearray(s.encode())
        for p in positions:
            b[p] = ord(char) if b[p] != ord(char) else ord("C")
        return bytes(b).decode()

    gb_seq = mut(base, range(50, 60))
    write_fasta("all.fa", ["a1", "a2", "a3", "b1", "bN"],
                [base, base, base, gb_seq,
                 gb_seq[:100] + "N" * 10 + gb_seq[110:]])
    merged = _cluster_both(["all.fa"], distance=1, pool=2)
    got = {c.name: sorted(c.neighbours) for c in merged}
    assert got == {"a1": ["a2", "a3"], "b1": ["bN"]}
    lines = lzma.open("port.csv.xz", "rt").read().strip().split("\n")
    assert sorted(lines) == ["a1,a2,a3", "b1,bN"]


def test_cluster_partial_saves(tmp_path, monkeypatch):
    """tests/test_tools.py:222: with save_interval=0 every batch writes
    a partial table by an atomic rename; the port's partial tables are
    the JAX package's, byte for byte."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(2)
    L = 120
    bb = rng.choice(list("ACGT"), L)
    with open("db.fa", "w") as f:
        for i in range(40):
            s = bb.copy()
            for p in rng.integers(0, L, i % 3):
                s[p] = rng.choice(list("ACGT"))
            f.write(f">s{i}\n{''.join(s)}\n")
    partials = {"jax": [], "port": []}
    real_replace = os.replace

    def spy_replace(src, dst):
        for who in partials:
            if str(dst) == f"{who}.csv.xz":
                partials[who].append(open(src, "rb").read())
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy_replace)
    _cluster_both(["db.fa"], distance=2, pool=8, save_interval=0.0)
    rows = lzma.open("port.csv.xz", "rt").read().strip().split("\n")
    names = [n for r in rows for n in r.split(",")]
    assert sorted(names) == sorted(f"s{i}" for i in range(40))
    assert len(partials["port"]) == 5
    assert partials["port"] == partials["jax"]
    for blob in partials["port"]:
        assert lzma.decompress(blob).decode().startswith("s")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_properties_randomized(tmp_path, monkeypatch, seed):
    """tests/test_tools.py:267: N runs, gaps and SNPs around six
    centres; both packages give the same bytes, and the port's clusters
    keep the properties that test pins (partition, <= distance
    connectivity, maximally resolved medoid)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(100 + seed)
    L, N, DIST = 160, 60, 2
    bb = rng.choice(list("ACGTN"), L, p=[0.24, 0.24, 0.24, 0.24, 0.04])
    centres = [bb.copy() for _ in range(6)]
    for c in centres:
        for p in rng.integers(0, L, 8):
            c[p] = rng.choice(list("ACGT"))
    seqs = {}
    for i in range(N):
        s = centres[rng.integers(0, 6)].copy()
        for p in rng.integers(0, L, rng.integers(0, 3)):
            s[p] = rng.choice(list("ACGTN-"))
        if rng.random() < 0.2:
            st = int(rng.integers(0, L - 12))
            s[st:st + 12] = "N"
        seqs[f"s{i}"] = "".join(s)
    write_fasta("db.fa", list(seqs), list(seqs.values()))
    merged = _cluster_both(["db.fa"], distance=DIST, pool=16)
    assert sorted(n for c in merged for n in [c.name] + c.neighbours) \
        == sorted(seqs)
    codes = {n: encode(s) for n, s in seqs.items()}
    for c in merged:
        members = [c.name] + c.neighbours
        reach, frontier = {members[0]}, [members[0]]
        while frontier:
            a = frontier.pop()
            for b in members:
                if b not in reach and oracle.pair_hamming_indelcheck(
                        codes[a], codes[b]) <= DIST:
                    reach.add(b)
                    frontier.append(b)
        assert reach == set(members)
        non_n = [int(np.count_nonzero(codes[n])) for n in members]
        assert non_n[0] == max(non_n)


@pytest.mark.parametrize("kw", [
    dict(distance=0), dict(distance=3, trim=20), dict(snps=3, pool=7),
    dict(snps=0), dict(codec="raw"), dict(codec="gz"),
    dict(reference="ref.fa")], ids=str)
def test_cluster_options_match_jax(tmp_path, monkeypatch, kw):
    """The options through both packages: --trim, -s, -r, codecs, a pool
    that does not divide the input (gzip output compared decompressed)."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(8)
    seqs = random_seqs(rng, 50, 240, mut=0.01)
    write_fasta("db.fa", [f"g{i}" for i in range(50)], seqs)
    write_fasta("ref.fa", ["ref"], [seqs[7]])
    args = dict(distance=2, pool=16)
    args.update(kw)
    suffix = {"raw": "", "gz": ".gz"}.get(kw.get("codec"), ".xz")
    _cluster_both(["db.fa"], suffix=suffix, **args)


def test_cluster_grows_tiers_and_tiles(tmp_path, monkeypatch):
    """More medoids than the first tier (x4 growth) and than one
    distance tile (the first hit across tiles), on both packages; the
    port's tile shrunk to 8 rows and its first tier to 16."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(9)
    seqs = random_seqs(rng, 90, 200, mut=0.05)
    seqs += [s[:100] + "N" * 5 + s[105:] for s in seqs[:30]]
    write_fasta("db.fa", [f"h{i}" for i in range(len(seqs))], seqs)
    monkeypatch.setattr(pcluster.MedoidIndex, "STORE_TILE", 8)
    real_init = pcluster.MedoidIndex.__init__
    tiers = []

    def small_tier(self, *a, **kw):
        real_init(self, *a, **{**kw, "initial_tier": 16})
        tiers.append(self)

    monkeypatch.setattr(pcluster.MedoidIndex, "__init__", small_tier)
    merged = _cluster_both(["db.fa"], distance=4, pool=32)
    assert tiers[0].n > 16 and tiers[0].tier > 16
    assert any(c.neighbours for c in merged)


def test_cluster_store_equivalence(tmp_path, monkeypatch):
    """tests/test_store.py:249: the port from a store it wrote itself ==
    the JAX package from the FASTA (and from its own store): the store's
    base, not the reference, is the rebuild's base there."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(7)
    seqs = _mk_genomes(rng, 37, 600)
    _write_fasta("db.fa.xz", [f"seq_{i:03d}|x" for i in range(37)], seqs)
    pstore.ingest(["db.fa.xz"], "port.uvst", block=8, frames=True)
    jstore.ingest(["db.fa.xz"], "jax.uvst", block=8, frames=True)
    base = pstore.peek_store_base("port.uvst")
    assert base is not None and not np.array_equal(
        base, encode(pcluster.build_reference("db.fa.xz", 1024)[0]))
    for jax_in, port_in in ((["db.fa.xz"], ["port.uvst"]),
                            (["jax.uvst"], ["port.uvst"]),
                            (["db.fa.xz"], ["jax.uvst"])):
        _cluster_both(jax_in, port_paths=port_in, distance=3, pool=16)


def test_cluster_store_mixed_inputs_rejected(tmp_path, monkeypatch):
    """tests/test_store.py:302."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    write_fasta("db.fa", [f"r{i}" for i in range(6)],
                random_seqs(rng, 6, 100))
    pstore.ingest(["db.fa"], "db.uvst")
    with pytest.raises(SystemExit, match="mix"):
        pcluster.run_cluster(["db.uvst", "db.fa"], pcluster.ClusterConfig(
            distance=2, output="mx", device="cpu"))


# ----------------------------------------------------------------------
# the distance product and the device fold


@pytest.mark.parametrize("B", [2, 17, 40])
def test_distance_product_equals_dist_expr(B):
    """valid - text matches through the 15 int8 planes, windowed by
    trim, against the JAX package's _dist_expr: random codes over all
    16 values, exactly."""
    rng = np.random.default_rng(B)
    L, trim, M = 203, 11, 33
    a = rng.integers(0, 16, (B, L)).astype(np.uint8)
    m = rng.integers(0, 16, (M, L)).astype(np.uint8)
    m[:min(B, 3)] = a[:3]                         # some near pairs
    m[1, 50:90] = 0
    jidx = jcluster.MedoidIndex(L, 64, trim, initial_tier=16)
    want = np.asarray(jidx._dist_expr(jnp.asarray(a), jnp.asarray(m)))
    pidx = pcluster.MedoidIndex(L, 64, trim, initial_tier=16)
    import torch
    got = pidx.dists(torch.from_numpy(a), torch.from_numpy(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and against the definition: valid pairs minus equal valid codes
    # that have a plane (pure, or ambiguity codes other than 15)
    np.testing.assert_array_equal(want, _dist_oracle(a, m, trim))


def _dist_oracle(a, m, trim):
    """(len(a), len(m)) valid pairs minus text matches over the window,
    from the definition."""
    L = a.shape[1]
    w = np.zeros(L, bool)
    w[trim:L - trim if trim else L] = True
    aw, mw = a * w, m * w
    valid = (aw[:, None] != 0) & (mw[None] != 0)
    text = valid & (aw[:, None] == mw[None]) & (aw[:, None] != 15)
    return valid.sum(-1) - text.sum(-1)


@pytest.mark.parametrize("tile", [8, 4096])
def test_first_hit_and_snp_positions(monkeypatch, tile):
    """assign's first hit is the lowest medoid index within the distance
    across every tile, and its per-row stats (non_n, dist_ref, the first
    -s SNP positions) equal _seq_stats, for the delta and the packed
    upload."""
    monkeypatch.setattr(pcluster.MedoidIndex, "STORE_TILE", tile)
    rng = np.random.default_rng(70 + tile)
    L, B, trim, n_snps, dist = 96, 21, 10, 3, 4
    ref = encode(bytes(rng.choice(list(b"ACGTN"), L).astype(np.uint8)))
    window = np.zeros(L, bool)
    window[trim:L - trim] = True
    meds = np.tile(ref, (40, 1))
    for r in range(40):
        meds[r, rng.integers(0, L, 3 + r % 5)] = rng.integers(0, 16)
    sparse = meds[rng.integers(0, 40, B)].copy()
    for b in range(B):
        sparse[b, rng.integers(0, L, rng.integers(0, 6))] = \
            rng.integers(0, 16)
    dense = rng.integers(0, 16, (B, L)).astype(np.uint8)
    dense[:4] = meds[[39, 20, 5, 0]]            # hits in late tiles
    ok = np.ones(B, bool)
    for codes in (sparse.astype(np.uint8), dense):
        idx = pcluster.MedoidIndex(L, 1 << 10, trim, initial_tier=16,
                                   delta_base=ref, stats_ref=ref,
                                   n_snps=n_snps)
        idx.append(meds.astype(np.uint8))
        assert idx.tier == 64
        first, d_self, non_n, dist_ref, snp, codes_d = idx.assign(
            codes, ok, dist)
        hit = _dist_oracle(codes, meds, trim) <= dist
        np.testing.assert_array_equal(
            first, np.where(hit.any(1), hit.argmax(1), -1))
        np.testing.assert_array_equal(
            d_self, _dist_oracle(codes, codes, trim) <= dist)
        e_non, e_dist, e_snp = pcluster._seq_stats(codes, ref, window,
                                                   n_snps)
        np.testing.assert_array_equal(non_n, e_non)
        np.testing.assert_array_equal(dist_ref, e_dist)
        assert [tuple(int(p) for p in r) for r in snp] == e_snp
        np.testing.assert_array_equal(codes_d.numpy(), codes)
    assert (first >= 0).any() and (first < 0).any()


def test_assign_matches_jax_on_every_payload():
    """tests/test_tools.py:348: the port's assign == the JAX package's
    on host codes (delta and packed uploads) and on store payloads — a
    delta against a base other than the index's own, and packed rows;
    and its stats == _seq_stats, the JAX package's spec."""
    rng = np.random.default_rng(7)
    L, B, trim, n_snps = 96, 12, 10, 3
    ref = encode(bytes(rng.choice(list(b"ACGTN"), L).astype(np.uint8)))
    sparse = np.tile(ref, (B, 1))
    for b in range(B):
        for p in rng.integers(0, L, rng.integers(0, 6)):
            sparse[b, p] = rng.integers(0, 16)
    sparse = sparse.astype(np.uint8)
    dense = rng.integers(0, 16, (B, L)).astype(np.uint8)
    ok = np.ones(B, bool)
    store_base = sparse[0]
    enc = host.delta_encode(sparse, ok, store_base)
    assert enc is not None
    for codes in (sparse, dense):
        mk = dict(delta_base=ref, stats_ref=ref, n_snps=n_snps,
                  initial_tier=16)
        jidx = jcluster.MedoidIndex(L, 1 << 10, trim, **mk)
        pidx = pcluster.MedoidIndex(L, 1 << 10, trim, **mk)
        jidx.append(codes[:2])
        pidx.append(codes[:2])
        want = jidx.assign(codes, ok, 2)
        runs = [pidx.assign(codes, ok, 2)]
        if codes is sparse:
            import torch
            runs.append(pidx.assign(None, ok, 2,
                                    payload=("delta", *enc),
                                    base_d=torch.from_numpy(store_base)))
            runs.append(pidx.assign(None, ok, 2, payload=(
                "packed", host.pack_codes(codes))))
        for got in runs:
            for w, g in zip(want[:-1], got[:-1], strict=True):
                np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(got[-1].numpy(),
                                          np.asarray(want[-1]))
        window = np.zeros(L, bool)
        window[trim:L - trim] = True
        e_non, e_dist, e_snp = pcluster._seq_stats(codes, ref, window,
                                                   n_snps)
        np.testing.assert_array_equal(runs[0][2], e_non)
        assert [tuple(int(p) for p in r) for r in runs[0][4]] == e_snp


def test_apply_updates_and_merge_match_jax():
    """The store copy (replacements, appends past a tier), a single-row
    replace and the close mask of the final merge, the port against the
    JAX package."""
    import torch
    rng = np.random.default_rng(5)
    L = 64
    rows = rng.integers(0, 16, (30, L)).astype(np.uint8)
    batch = rng.integers(0, 16, (20, L)).astype(np.uint8)
    jidx = jcluster.MedoidIndex(L, 1 << 10, 0, initial_tier=16)
    pidx = pcluster.MedoidIndex(L, 1 << 10, 0, initial_tier=16)
    jidx.append(rows[:10])
    pidx.append(rows[:10])
    repl, new = {3: 5, 7: 0}, [1, 2, 4, 6, 8, 9, 11, 12, 13]
    jidx.apply_updates(jnp.asarray(batch), repl, new)
    pidx.apply_updates(torch.from_numpy(batch), repl, new)
    assert (pidx.n, pidx.tier) == (jidx.n, jidx.tier) == (19, 64)
    jidx.replace(4, rows[29])
    pidx.replace(4, rows[29])
    np.testing.assert_array_equal(pidx._codes.numpy(),
                                  np.asarray(jidx._codes))
    d = 30
    want = jidx.close_vs(jidx._codes[:8], jidx._codes, d)[:, :19]
    got = pidx.close_vs(pidx._codes[:8], d)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_cluster_cli_ingest_and_info(tmp_path, monkeypatch, capsys):
    """`python -m uvaia_tpu_torch ingest`, `info` and `cluster` through
    the port's command line against uvaia_tpu's: the same store files,
    the same info text and JSON, the same cluster bytes; the plain
    rebuild launches no kernel; `cluster` without a GPU refuses."""
    from uvaia_tpu.cli import main as jax_cli
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    seqs = random_seqs(rng, 30, 180, mut=0.01)
    write_fasta("db.fa", [f"c{i}" for i in range(30)], seqs)
    assert jax_cli.main(["ingest", "db.fa", "-o", "jax.uvst", "--block",
                         "8"]) == 0
    assert port_main(["ingest", "db.fa", "-o", "port.uvst", "--block",
                      "8"]) == 0
    for f in sorted(os.listdir("jax.uvst")):
        assert open(f"port.uvst/{f}", "rb").read() == \
            open(f"jax.uvst/{f}", "rb").read(), f
    capsys.readouterr()
    for flags in ([], ["--json"], ["--verify"], ["--verify", "--json"]):
        assert jax_cli.main(["info", "jax.uvst", *flags]) == 0
        want = capsys.readouterr().out.replace("jax.uvst", "X")
        assert port_main(["info", "port.uvst", *flags]) == 0
        assert capsys.readouterr().out.replace("port.uvst", "X") == want
    assert jax_cli.main(["cluster", "port.uvst", "-d", "3", "-p", "8", "-s",
                         "2", "-o", "jax"]) == 0
    before = recon.delta_rebuild.launches
    assert port_main(["cluster", "port.uvst", "-d", "3", "-p", "8", "-s",
                      "2", "-o", "port", "--device", "cpu"]) == 0
    assert recon.delta_rebuild.launches == before
    for ext in (".csv.xz", ".aln.xz"):
        assert open("port" + ext, "rb").read() == \
            open("jax" + ext, "rb").read()
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["cluster", "db.fa"])
