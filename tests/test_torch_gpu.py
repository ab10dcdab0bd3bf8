"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and `nearest` (full mode and --acgt) and `align` on the card
against the same runs on the CPU.

Every test here needs a CUDA GPU and skips without one.  The file
imports no jax, so it also runs where jax is not installed, without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import filecmp

import numpy as np
import pytest
import torch

from uvaia_tpu_torch.core.encoding import encode
from uvaia_tpu_torch.engine import align, nearest
from uvaia_tpu_torch.engine.query import QueryPack
from uvaia_tpu_torch.ops import gotoh, gotoh_kernels as gk
from uvaia_tpu_torch.ops import host, recon, scan, score_kernels as sk

LETTERS = np.frombuffer(b"ACGTACGTACGTACGTN-RYMKSWBDHV", dtype=np.uint8)


def _alignment(rng, n, L, mut):
    """(n, L) letters: one backbone plus mutations, Ns and ambiguities."""
    seqs = np.tile(LETTERS[rng.integers(0, 4, L)], (n, 1))
    m = rng.random((n, L)) < mut
    seqs[m] = LETTERS[rng.integers(0, len(LETTERS), int(m.sum()))]
    return seqs


def _codes(rng, n, L, mut=0.1):
    return np.stack([encode(s) for s in _alignment(rng, n, L, mut)])


def _pack(rng, Q, L, acgt=False):
    pack = QueryPack(names=[f"q{i}" for i in range(Q)],
                     codes=_codes(rng, Q, L, 0.03), acgt=acgt, trim=0)
    pack.create_indices()
    return pack


def _write(path, prefix, letters):
    with open(path, "wb") as f:
        for i, row in enumerate(letters):
            f.write(b">%s%d\n%s\n" % (prefix.encode(), i, row.tobytes()))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.device == w.device and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 7, 64, 129])
def test_gpu_counters_match_plain(cuda_device, Q):
    rng = np.random.default_rng(60 + Q)
    L = 2501
    qd = scan.build_device_data(_pack(rng, Q, L), k=5, device=cuda_device)
    codes = _codes(rng, 300, L)
    r = scan._to_width(torch.from_numpy(codes).to(cuda_device), qd.width)
    _equal(sk.score_counters(r, qd.q_full, qd.cons_full),
           sk.score_counters_plain(r, qd.q_full, qd.cons_full))
    pk = torch.from_numpy(host.pack_codes(codes)).to(cuda_device)
    _equal(sk.score_counters_packed(pk, qd.q_full, qd.cons_full),
           sk.score_counters_packed_plain(pk, qd.q_full, qd.cons_full))


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 7, 64, 129])
@pytest.mark.parametrize("B", [33, 300])
def test_gpu_acgt_and_pair_counters_match_plain(cuda_device, B, Q):
    """The --acgt kernel, unpacked and packed, and the pair counters at
    an odd site count (the wrapper pads to 64 sites), each launched once
    and equal to its plain version."""
    rng = np.random.default_rng(70 + B + Q)
    L = 2501
    qd = scan.build_device_data(_pack(rng, Q, L, acgt=True), k=5,
                                device=cuda_device)
    codes = _codes(rng, B, L)
    r = scan._to_width(torch.from_numpy(codes).to(cuda_device), qd.width)
    pk = torch.from_numpy(host.pack_codes(codes)).to(cuda_device)
    q = (qd.q_full, qd.q_poly, qd.cons_full)
    wrappers = (sk.acgt_counters, sk.acgt_counters_packed, sk.pair_counters)
    before = [w.launches for w in wrappers]
    _equal(sk.acgt_counters(r, *q), sk.acgt_counters_plain(r, *q))
    _equal(sk.acgt_counters_packed(pk, *q),
           sk.acgt_counters_packed_plain(pk, *q))
    rs = torch.from_numpy(codes).to(cuda_device)
    qs = qd.q_full[:, :L].contiguous()
    _equal(sk.pair_counters(rs, qs), sk.pair_counters_plain(rs, qs))
    assert [w.launches for w in wrappers] == [n + 1 for n in before]


def _operands(rng, dev, B, Q, L):
    """Unpacked (B, W) and packed (B, P) reference codes, q_full, q_poly
    (q_full on about half the sites) and a consensus on `dev`, W = L
    rounded up to 64 sites (code 0 beyond L)."""
    W = -(-L // 64) * 64
    pad = lambda x: np.pad(x, ((0, 0), (0, W - L)))
    codes = _codes(rng, B, L)
    q = _codes(rng, Q, L, 0.05)
    p = np.where(rng.random((Q, L)) < 0.5, q, 0).astype(np.uint8)
    cons = np.where(rng.random(L) < 0.7, q[0], 0).astype(np.uint8)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (t(pad(codes)), t(host.pack_codes(codes)), t(pad(q)), t(pad(p)),
            t(pad(cons[None, :])[0]))


COUNTERS = (
    (sk.score_counters, sk.score_counters_plain, False, False),
    (sk.score_counters_packed, sk.score_counters_packed_plain, True, False),
    (sk.acgt_counters, sk.acgt_counters_plain, False, True),
    (sk.acgt_counters_packed, sk.acgt_counters_packed_plain, True, True))


def _counter_args(ops, packed, acgt):
    r, pk, q, p, cons = ops
    return ((pk if packed else r), q, *((p,) if acgt else ()), cons)


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 7, 64, 129, 1000])
@pytest.mark.parametrize("B", [33, 300, 4096])
def test_gpu_tensor_core_counters_match_plain(cuda_device, B, Q):
    """Every counter kernel (full mode and --acgt, unpacked and packed),
    with its consensus outputs, equals its plain version at ragged B and
    Q: partial reference and query tiles, and site splits (few tiles)."""
    rng = np.random.default_rng(B * 7 + Q)
    ops = _operands(rng, cuda_device, B, Q, 2501)
    for fn, plain, packed, acgt in COUNTERS:
        args = _counter_args(ops, packed, acgt)
        before = fn.launches
        _equal(fn(*args), plain(*args))
        assert fn.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [7, 64])
def test_gpu_counters_full_width(cuda_device, Q):
    """At the main path's width (L=29903, W=30720, B=4096) and at odd
    packed rows whose 2P exceeds the real site count."""
    rng = np.random.default_rng(90 + Q)
    ops = _operands(rng, cuda_device, 4096, Q, 29903)
    for fn, plain, packed, acgt in COUNTERS:
        args = _counter_args(ops, packed, acgt)
        _equal(fn(*args), plain(*args))


@pytest.mark.gpu
def test_gpu_pair_counters_unpadded_sites(cuda_device):
    """pair_counters at S=29903 (the wrapper pads to 64 sites)."""
    rng = np.random.default_rng(31)
    rs = torch.from_numpy(_codes(rng, 300, 29903)).to(cuda_device)
    qs = torch.from_numpy(_codes(rng, 64, 29903, 0.05)).to(cuda_device)
    _equal(sk.pair_counters(rs, qs), sk.pair_counters_plain(rs, qs))


@pytest.mark.gpu
def test_gpu_consensus_outputs_independent_of_queries(cuda_device):
    """cons5 depends on the references and the consensus alone: the same
    for 1 query and for 200 (another grid, another site split), and equal
    to the plain version's."""
    rng = np.random.default_rng(41)
    ops = _operands(rng, cuda_device, 300, 200, 6000)
    r, pk, q, p, cons = ops
    for fn, plain, packed, acgt in COUNTERS:
        args = _counter_args(ops, packed, acgt)
        one = _counter_args((r, pk, q[:1].contiguous(), p[:1].contiguous(),
                             cons), packed, acgt)
        want = plain(*args)[-1]
        assert torch.equal(fn(*args)[-1], want)
        assert torch.equal(fn(*one)[-1], want)


@pytest.mark.gpu
def test_gpu_counters_bit_identical_across_runs(cuda_device):
    """A site-split launch (few tiles, W=30720: the splits add with int32
    atomics) gives bit-identical results when run twice."""
    rng = np.random.default_rng(43)
    ops = _operands(rng, cuda_device, 300, 7, 29903)
    for fn, _, packed, acgt in COUNTERS:
        args = _counter_args(ops, packed, acgt)
        first = [x.clone() for x in fn(*args)]
        _equal(fn(*args), first)


def _corr_inputs(rng, dev, B, Q, A):
    """Codes dense in ambiguity (every code 0-15), some all-15 columns
    and an all-zero reference row."""
    r = rng.integers(0, 16, (B, A)).astype(np.uint8)
    q = rng.integers(0, 16, (Q, A)).astype(np.uint8)
    r[:, :2] = 15
    q[:, 1:3] = 15
    r[0, :] = 0
    return torch.from_numpy(r).to(dev), torch.from_numpy(q).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("A", [4, 40, 256, 12000])
@pytest.mark.parametrize("Q", [1, 64, 129, 1000])
@pytest.mark.parametrize("B", [33, 4096])
def test_gpu_corr_matches_plain(cuda_device, B, Q, A):
    """The tensor-core corrections at ragged B, Q and A (A no multiple
    of the 64-site chunk: the staging zero-fills the tail), with and
    without site splits, equal the plain version and its plane
    products."""
    r, q = _corr_inputs(np.random.default_rng(B + Q + A), cuda_device,
                        B, Q, A)
    before = sk.amb_corr.launches
    got = sk.amb_corr(r, q)
    assert sk.amb_corr.launches == before + 1
    _equal(got, sk.amb_corr_products(r, q))
    if B * Q * A <= 4096 * 129 * 12000:     # the plain version's seconds
        _equal(got, sk.amb_corr_plain(r, q))


@pytest.mark.gpu
def test_gpu_corr_every_code_pair(cuda_device):
    codes = torch.arange(16, dtype=torch.uint8,
                         device=cuda_device)[:, None].repeat(1, 12)
    _equal(sk.amb_corr(codes, codes.clone()),
           sk.amb_corr_plain(codes, codes.clone()))


@pytest.mark.gpu
@pytest.mark.parametrize("pos_dtype", [np.uint16, np.int32])
def test_gpu_rebuild_matches_plain(cuda_device, pos_dtype):
    rng = np.random.default_rng(9)
    L = 1900
    codes = _codes(rng, 50, L, 0.02)
    for i in range(0, 50, 2):                  # zero runs -> run markers
        s = int(rng.integers(0, L - 100))
        codes[i, s:s + int(rng.integers(3, 100))] = 0
    codes[3, L - 77:] = 0
    ok = np.ones(50, dtype=bool)
    ok[4] = False
    base = host.majority_code(codes)
    pos, val = host.delta_encode(codes, ok, base)
    assert (val >= 16).any()
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (pos.astype(pos_dtype), val, base)]
    got = recon.delta_rebuild(*args, 2048)
    assert torch.equal(got, recon.delta_rebuild_plain(*args, 2048))
    want = np.where(ok[:, None], codes, base[None, :])
    np.testing.assert_array_equal(got[:, :L].cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("prune", [True, False])
def test_gpu_nearest_matches_cpu(cuda_device, tmp_path, monkeypatch, prune):
    """The whole slice on the card writes the bytes the plain versions
    write on the CPU."""
    _nearest_cuda_vs_cpu(tmp_path, monkeypatch, prune)


@pytest.mark.gpu
@pytest.mark.parametrize("prune", [True, False])
def test_gpu_nearest_acgt_matches_cpu(cuda_device, tmp_path, monkeypatch,
                                      prune):
    """`nearest --acgt` on the card writes the CPU run's bytes, through
    the --acgt kernels."""
    before = sk.acgt_counters.launches + sk.acgt_counters_packed.launches
    _nearest_cuda_vs_cpu(tmp_path, monkeypatch, prune, acgt=True)
    assert sk.acgt_counters.launches + sk.acgt_counters_packed.launches \
        > before


def _nearest_cuda_vs_cpu(tmp_path, monkeypatch, prune, acgt=False):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    L = 3000
    q = _alignment(rng, 6, L, 0.03)
    db = np.concatenate([np.resize(q, (40, L)), _alignment(rng, 200, L, 0.05)])
    db[rng.random(db.shape) < 0.01] = ord("T")
    _write("q.fa", "q", q)
    _write("db.fa", "r", db)
    for dev in ("cuda", "cpu"):
        nearest.run_nearest(["db.fa"], "q.fa", nearest.NearestConfig(
            nbest=7, pool=64, prune=prune, device=dev, output=dev,
            acgt=acgt))
    for ext in (".csv.xz", ".aln.xz"):
        assert filecmp.cmp("cuda" + ext, "cpu" + ext, shallow=False)


def _dna(rng, n):
    return LETTERS[rng.integers(0, 4, n)].tobytes()


def _gotoh_inputs(rng, n, B, dev):
    """ref (n,), q (B, m_pad), qlen (B,) on `dev`: SNPs, indels up to 30
    bases, short and long ends, zero padding past every row."""
    ref = _dna(rng, n)
    qs = []
    for b in range(B):
        q = bytearray(ref)
        for _ in range(int(rng.integers(0, 10))):
            q[int(rng.integers(0, n))] = ord("ACGT"[int(rng.integers(0, 4))])
        p, ln = int(rng.integers(0, n - 40)), int(rng.integers(1, 31))
        if b % 2:
            del q[p:p + ln]
        else:
            q[p:p] = _dna(rng, ln)
        if b % 3 == 1:
            q = q[:len(q) - int(rng.integers(1, 30))]
        qs.append(bytes(q))
    m_pad = max(map(len, qs)) + 29
    arr = np.zeros((B, m_pad), np.uint8)
    for b, q in enumerate(qs):
        arr[b, :len(q)] = np.frombuffer(q, np.uint8)
    lens = np.array([len(q) for q in qs], np.int32)
    return [torch.from_numpy(x).to(dev)
            for x in (np.frombuffer(ref, np.uint8).copy(), arr, lens)]


GOTOH_CASES = [
    (300, -64, 129, 13), (80, -8, 17, 8), (300, -512, 1025, 3),
    # the wide kernel: H and X in shared memory, the query read from
    # device memory
    (2000, -7168, 14337, 2),
    # an exact-fallback width: H and X in the device-memory scratch
    (300, -7680, 15361, 2)]
# every band width of the register kernel's variants (one warp a row up
# to 544, then a CTA) at n = 1, 2 and 400, the batch sizes in turn
GOTOH_CASES += [(n, -(W // 2), W, (1, 3, 64, 256)[(k + m) % 4])
                for k, W in enumerate((1, 32, 33, 129, 257, 513, 544, 545,
                                       1025, 4097, 4352, 4353))
                for m, n in enumerate((1, 2, 400))]
GOTOH_CASES += [(400, -64, 129, 256), (400, -64, 129, 64), (400, -70, 129, 1),
                (400, -256, 513, 256), (400, -2048, 4097, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,lo,width,B", GOTOH_CASES)
def test_gpu_gotoh_matches_plain(cuda_device, n, lo, width, B):
    rng = np.random.default_rng(n + width)
    args = _gotoh_inputs(rng, max(n, 64), B, cuda_device)
    args[0] = args[0][:n].contiguous()
    before = gk.gotoh_forward.launches, gk.gotoh_score.launches
    _equal(gk.gotoh_forward(*args, lo, width),
           gk.gotoh_forward_plain(*args, lo, width))
    _equal(gk.gotoh_score(*args, lo, width),
           gk.gotoh_score_plain(*args, lo, width))
    assert (gk.gotoh_forward.launches, gk.gotoh_score.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_gpu_redesigned_kernels_bit_identical_across_runs(cuda_device):
    """gotoh_forward, gotoh_score (one warp a row, a CTA a row, the wide
    kernel) and amb_corr (a site-split launch: int32 atomics) give
    bit-identical outputs when run twice."""
    rng = np.random.default_rng(77)
    args = _gotoh_inputs(rng, 400, 64, cuda_device)
    for lo, width in ((-64, 129), (-512, 1025), (-2200, 4401)):
        for fn in (gk.gotoh_forward, gk.gotoh_score):
            first = [x.clone() for x in fn(*args, lo, width)]
            _equal(fn(*args, lo, width), first)
    r, q = _corr_inputs(rng, cuda_device, 300, 7, 12000)
    first = [x.clone() for x in sk.amb_corr(r, q)]
    _equal(sk.amb_corr(r, q), first)


@pytest.mark.gpu
@pytest.mark.parametrize("ev_cap", [gotoh.EV_CAP, 4])
def test_gpu_align_matches_cpu(cuda_device, tmp_path, monkeypatch, ev_cap):
    """align on the card writes the bytes the plain versions write on the
    CPU: SNPs, indels, an N-heavy row certified beyond --band, a row
    whose optimum wanders out of the routed band, a truncated row;
    EV_CAP = 4 sends the gapped rows through the dense walk."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(gotoh, "EV_CAP", ev_cap)
    rng = np.random.default_rng(17)
    n = 900
    ref = _dna(rng, n)
    qs = [ref, ref[:100] + ref[104:], ref[:300] + b"ACG" + ref[300:],
          b"N" * 300 + ref[300:], ref[:200] + _dna(rng, 120) + ref[200:500]
          + ref[620:], ref[150:]]
    for k in range(6):
        q = bytearray(ref)
        for p in (int(x) for x in rng.integers(0, n, 12)):
            q[p] = ord("ACGT"[(q[p] + k) % 4])
        del q[50 * (k + 1):50 * (k + 1) + k + 1]
        qs.append(bytes(q))
    with open("ref.fa", "wb") as f:
        f.write(b">ref\n" + ref + b"\n")
    _write("q.fa", "q", [np.frombuffer(q, np.uint8) for q in qs])
    stats = {}
    for dev in ("cuda", "cpu"):
        stats[dev] = align.run_align("ref.fa", ["q.fa"], align.AlignConfig(
            band=256, device=dev, output=dev))
    assert stats["cuda"] == stats["cpu"]
    assert stats["cuda"].n_output == len(qs)
    assert filecmp.cmp("cuda.aln.xz", "cpu.aln.xz", shallow=False)
