"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and `nearest` (full mode and --acgt, on one device and over a
mesh of shards that share the card), `align` and `cluster` on the card
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
from uvaia_tpu_torch.engine import align, cluster, nearest
from uvaia_tpu_torch.engine.query import QueryPack
from uvaia_tpu_torch.ops import gotoh, gotoh_kernels as gk
from uvaia_tpu_torch.ops import host, recon, scan, score_kernels as sk
from uvaia_tpu_torch.parallel import mesh as pmesh
from uvaia_tpu_torch.utils import observe

import torch_cases

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


def _rebuild_on_card(dev, pos, val, base, width, base_offset=0):
    """The kernel's rows and the plain version's on the same tensors."""
    b = torch.from_numpy(np.concatenate(
        [np.zeros(base_offset, np.uint8), base])).to(dev)[base_offset:]
    args = [torch.from_numpy(x).to(dev) for x in (pos, val)] + [b]
    before = recon.delta_rebuild.launches
    got = recon.delta_rebuild(*args, width)
    torch.cuda.synchronize()
    assert recon.delta_rebuild.launches == before + (pos.shape[0] > 0)
    want = recon.delta_rebuild_plain(
        *args, base.shape[0] if width is None else width)
    assert torch.equal(got, want)
    return got.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("width", [None, 208, 211, 256])
def test_gpu_rebuild_named_odd_rows(cuda_device, width):
    names, pos, val, base, want = torch_cases.named_delta_rows()
    got = _rebuild_on_card(cuda_device, pos, val, base, width)
    for name, b in names.items():
        np.testing.assert_array_equal(got[b, :200], want[b], err_msg=name)


# B, E, L, width, positions, ascending, bytes the base is shifted by
REBUILD_CASES = [
    (64, 128, 900, None, np.uint16, True, 0),     # rows at 4 store phases
    (64, 128, 901, None, np.int32, True, 0),      # rows at all 16 phases
    (64, 128, 901, 915, np.uint16, True, 3),      # base not 16-byte aligned
    (700, 128, 2999, 3072, np.uint16, True, 0),   # more rows than CTAs
    (700, 256, 2999, 3001, np.uint16, False, 0),  # shuffled slots
    (40, 4096, 5003, 5120, np.uint16, True, 0),   # the largest bucket
    (40, 4096, 5003, None, np.int32, False, 5),
    (9, 16, 70000, 70016, np.int32, True, 0),     # positions past uint16
    (3, 4096, 29903, recon.MAX_WIDTH, np.uint16, True, 0),
    (1, 1, 1, None, np.uint16, True, 0),
    (5, 2, 17, 33, np.int32, False, 1),
    (0, 128, 900, 1024, np.uint16, True, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,E,L,width,pos_dtype,ascending,shift",
                         REBUILD_CASES)
def test_gpu_rebuild_random_markers(cuda_device, B, E, L, width, pos_dtype,
                                    ascending, shift):
    """Nested starts, early ends, open runs, codes inside runs, padding,
    empty and marker-free rows; ragged widths put the rows at every
    16-byte phase; any order of slots; twice, to the same bytes."""
    pos, val, base = torch_cases.random_delta_batch(
        B + E + L, max(B, 1), E, L, ascending=ascending,
        pos_dtype=pos_dtype)
    pos, val = pos[:B], val[:B]
    a = _rebuild_on_card(cuda_device, pos, val, base, width, shift)
    b = _rebuild_on_card(cuda_device, pos, val, base, width, shift)
    np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 100, 529, 1500, 5000])
def test_gpu_rebuild_any_grid(cuda_device, B):
    """Fewer rows than the persistent grid has CTAs, one more than it
    holds (528 on a 132-SM card), and several rounds of it."""
    pos, val, base = torch_cases.random_delta_batch(77, B, 128, 2999)
    _rebuild_on_card(cuda_device, pos, val, base, 3072)


@pytest.mark.gpu
def test_gpu_rebuild_refuses_what_shared_memory_cannot_hold(cuda_device):
    z = lambda *s, dt=torch.uint8: torch.zeros(s, dtype=dt,
                                               device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        recon.delta_rebuild(z(2, 4096, dt=torch.int32), z(2, 4096), z(100),
                            recon.MAX_WIDTH + 32)


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


def _walks(tb, ref, q, t_end, lo, n, K):
    return (gotoh.gotoh_traceback_events(tb, t_end, lo, n, K)
            + gotoh.gotoh_traceback(tb, ref, q, t_end, lo, n))


@pytest.mark.gpu
@pytest.mark.parametrize("name", torch_cases.GAP_CASES)
def test_gpu_walks_retire_gap_runs(cuda_device, name):
    """Both walks on the card against the same walks on the CPU, from
    the kernel's traceback bytes (equal to the plain version's)."""
    ref, arr, lens, lo, W = torch_cases.gap_case(name)
    host_in = [torch.from_numpy(x) for x in (ref, arr, lens)]
    card_in = [x.to(cuda_device) for x in host_in]
    tb, _, t_end, _ = gk.gotoh_forward(*card_in, lo, W)
    tb_h, _, t_end_h, _ = gk.gotoh_forward(*host_in, lo, W)
    assert torch.equal(tb.cpu(), tb_h)
    got = _walks(tb, *card_in[:2], t_end, lo, len(ref), gotoh.EV_CAP)
    want = _walks(tb_h, *host_in[:2], t_end_h, lo, len(ref), gotoh.EV_CAP)
    _equal([g.cpu() for g in got], want)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(4))
def test_gpu_walks_on_arbitrary_traceback_bytes(cuda_device, seed):
    rng = np.random.default_rng(seed)
    n, B, lo, W = 40, 64, -9, 17
    tb = rng.integers(0, 32, (n, B, W)).astype(np.uint8)
    tb[(tb & 3) == 3] &= 0xFC
    host_in = [torch.from_numpy(x) for x in (
        tb, torch_cases.ACGT[rng.integers(0, 4, n)],
        torch_cases.ACGT[rng.integers(0, 4, (B, n + 9))],
        rng.integers(0, W, B).astype(np.int32))]
    got = _walks(*[x.to(cuda_device) for x in host_in], lo, n, 8)
    _equal([g.cpu() for g in got], _walks(*host_in, lo, n, 8))


@pytest.mark.gpu
def test_gpu_walks_read_the_host_rarely(cuda_device, monkeypatch):
    """The dense walk reads its loop condition once every HOST_READ_EVERY
    iterations; the events walk, one kernel, adds no iteration and no
    host read."""
    rng = np.random.default_rng(12)
    ref, arr, lens = _gotoh_inputs(rng, 2000, 64, cuda_device)
    tb, _, t_end, _ = gk.gotoh_forward(ref, arr, lens, -64, 129)
    want = _walks(tb, ref, arr, t_end, -64, 2000, 4)
    for every in (1, 32):
        monkeypatch.setattr(gotoh, "HOST_READ_EVERY", every)
        before = dict(gotoh.walk_counts)
        got = gotoh.gotoh_traceback_events(tb, t_end, -64, 2000, 4)
        assert gotoh.walk_counts == before
        got += gotoh.gotoh_traceback(tb, ref, arr, t_end, -64, 2000)
        _equal(got, want)
        iters = gotoh.walk_counts["iterations"] - before["iterations"]
        reads = gotoh.walk_counts["host_reads"] - before["host_reads"]
        assert reads == iters // every + 1


# (n, lo, W, B): the first band level, the escalation width, a band wider
# than the probe's reach, one row, batches that are no multiple of 32
WALK_CASES = [(300, -64, 129, 13), (2000, -256, 513, 64),
              (2000, -512, 1024, 33), (600, -1024, 2049, 5),
              (5000, -64, 129, 1), (4500, -8, 17, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("K", [gotoh.EV_CAP, 3])
@pytest.mark.parametrize("n,lo,width,B", WALK_CASES)
def test_gpu_walk_kernel_matches_plain(cuda_device, n, lo, width, B, K):
    """The walk kernel against the plain events walk on the same card
    tensors, every output equal: on the forward's traceback bytes and on
    random bytes of the same shape (rows that overflow K = 3, leave the
    band, get stuck and stop at the cap); its all-M flags equal the
    plain version's; one launch a call."""
    rng = np.random.default_rng(n + width + B)
    ref, arr, lens = _gotoh_inputs(rng, max(n, 64), B, cuda_device)
    tb, _, t_end, _ = gk.gotoh_forward(ref[:n].contiguous(), arr, lens,
                                       lo, width)
    noise = torch.from_numpy(rng.integers(0, 32, tuple(tb.shape)).astype(
        np.uint8)).to(cuda_device)
    shift = torch.from_numpy(rng.integers(-3, width + 3, B).astype(
        np.int32)).to(cuda_device)
    for tb_x, t_x in ((tb, t_end), (noise, shift)):
        before = gk.walk_events.launches
        got = gk.walk_events(tb_x, t_x, lo, n, K)
        assert gk.walk_events.launches == before + 1
        _equal(got, gotoh.walk_events_plain(tb_x, t_x, lo, n, K))
        _equal(gk.allm_flags(tb_x, n),
               [x.to(torch.uint8) for x in gotoh._all_m_blocks(tb_x, n)[2:]])


@pytest.mark.gpu
def test_gpu_walk_kernel_counts_its_rows(cuda_device):
    rng = np.random.default_rng(3)
    ref, arr, lens = _gotoh_inputs(rng, 400, 37, cuda_device)
    tb, _, t_end, _ = gk.gotoh_forward(ref, arr, lens, -64, 129)
    with observe.job("align") as root:
        gotoh.gotoh_traceback_events(tb, t_end, -64, 400, 8)
        gotoh.gotoh_traceback_events(tb[:, :5].contiguous(),
                                     t_end[:5].contiguous(), -64, 400, 8)
    assert root.counts["walk_kernel_rows"] == 42


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


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 17, 40])
def test_gpu_cluster_distance_product_matches_cpu(cuda_device, B):
    """cluster's int8 product (torch._int_mm) on the card: rows padded to
    its 17-row minimum, sites to a multiple of 8, the same int32
    distances as on the CPU, over all 16 codes with --trim."""
    rng = np.random.default_rng(B)
    L, trim, M = 2003, 11, 37
    a = rng.integers(0, 16, (B, L)).astype(np.uint8)
    m = rng.integers(0, 16, (M, L)).astype(np.uint8)
    m[:min(B, 3)] = a[:3]
    got = {}
    for dev in ("cuda", "cpu"):
        idx = cluster.MedoidIndex(L, 64, trim, initial_tier=16, device=dev)
        got[dev] = idx.dists(torch.from_numpy(a).to(dev),
                             torch.from_numpy(m).to(dev))
    assert got["cuda"].dtype == torch.int32
    assert torch.equal(got["cuda"].cpu(), got["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("L", [2999, 29903])
def test_gpu_cluster_assign_rebuilds_at_width_L(cuda_device, L):
    """assign on the card rebuilds the delta batch through delta_rebuild
    at the ragged width L (one launch), and returns what the CPU index
    returns from the plain rebuild."""
    rng = np.random.default_rng(L)
    codes = np.stack([encode(r) for r in _alignment(rng, 40, L, 0.002)])
    codes[::3, 100:400] = 0
    ref = host.majority_code(codes)           # few diffs: a delta batch
    ok = np.ones(40, bool)
    out = {}
    for dev in ("cuda", "cpu"):
        idx = cluster.MedoidIndex(L, 1 << 10, 7, initial_tier=16,
                                  delta_base=ref, stats_ref=ref, n_snps=2,
                                  device=dev)
        idx.append(codes[:5])
        before = recon.delta_rebuild.launches
        out[dev] = idx.assign(codes, ok, 12)
        assert recon.delta_rebuild.launches == before + (dev == "cuda")
    for g, w in zip(out["cuda"][:-1], out["cpu"][:-1], strict=True):
        np.testing.assert_array_equal(g, w)
    assert out["cuda"][-1].shape == (40, L)
    assert torch.equal(out["cuda"][-1].cpu(), out["cpu"][-1])
    np.testing.assert_array_equal(out["cpu"][-1].numpy(), codes)


@pytest.mark.gpu
def test_gpu_cluster_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """cluster on the card from FASTA and from the store the port wrote:
    the bytes of the plain run on the CPU."""
    from uvaia_tpu_torch.io.store import ingest
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(23)
    _write("db.fa", "g", _alignment(rng, 300, 1501, 0.004))
    ingest(["db.fa"], "db.uvst", block=64)
    for src in ("db.fa", "db.uvst"):
        for dev in ("cuda", "cpu"):
            cluster.run_cluster([src], cluster.ClusterConfig(
                distance=4, pool=48, snps=2, device=dev, output=dev))
        for ext in (".csv.xz", ".aln.xz"):
            assert filecmp.cmp("cuda" + ext, "cpu" + ext, shallow=False)


@pytest.mark.gpu
@pytest.mark.parametrize("acgt", [False, True])
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_gpu_sharded_steps_match_one_device(cuda_device, monkeypatch, shape,
                                            acgt):
    """A mesh of shards that all name cuda:0: the sharded step (packed
    and delta batches) gives the one-device steps' state and flags, and
    the survivor path (prune_acc, prune_acc_delta, flush) the dense
    state, through the kernels."""
    monkeypatch.setattr(pmesh, "local_devices",
                        lambda kind, n: [torch.device("cuda", 0)] * n)
    rng = np.random.default_rng(11 + shape[1] + 2 * acgt)
    L, Q, B, k = 2501, 7, 64, 5
    pack = _pack(rng, Q, L, acgt=acgt)
    m = pmesh.make_mesh(*shape)
    qd_s = scan.build_device_data(pack, k=k, device=cuda_device,
                                  site_shards=shape[1])
    qd_1 = scan.build_device_data(pack, k=k, device=cuda_device)
    scan.build_prune_data(qd_s, pack)
    assert acgt or qd_s.amb_sites is not None
    base = qd_s.delta_base.cpu().numpy()
    step = pmesh.make_sharded_scan_step(qd_s, m)
    step_d = pmesh.make_sharded_scan_step(qd_s, m, delta=True)
    cap = 2 * (B // shape[0])
    init, acc, acc_d, flush = pmesh.make_sharded_survivor_ops(qd_s, m, cap)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
    st_s = scan.init_state(Q, k, device=cuda_device)
    st_1 = scan.init_state(Q, k, device=cuda_device)
    st_v = scan.init_state(Q, k, device=cuda_device)
    bufs = init()
    counters = sk.acgt_counters if acgt else sk.score_counters
    before = (counters.launches, recon.delta_rebuild.launches)
    ok = np.ones(B, dtype=bool)
    with sk.full_float32_matmuls():
        for i in range(4):
            codes = _codes(rng, B, L, 0.02)
            ridx = t(i * B + np.arange(B, dtype=np.int32))
            if i % 2:
                pos, val = (t(x) for x in host.delta_encode(codes, ok, base))
                st_s, fl_s = step_d(st_s, pos, val, t(ok), ridx)
                st_1, fl_1 = scan.scan_step_delta(qd_1, st_1, pos, val,
                                                  t(ok), i * B)
                _, bufs = acc_d(st_v, bufs, pos, val, t(ok), ridx)
            else:
                packed = t(host.pack_codes(codes))
                st_s, fl_s = step(st_s, packed, t(ok), ridx)
                st_1, fl_1 = scan.scan_step_packed(qd_1, st_1, packed,
                                                   t(ok), i * B)
                _, bufs = acc(st_v, bufs, packed, t(ok), ridx)
            _equal(fl_s, fl_1)
            _equal(st_s, st_1)
            if int(bufs.fill().max()) + B // shape[0] > cap:
                st_v, _, bufs = flush(st_v, bufs)
        st_v, _, bufs = flush(st_v, bufs)
    _equal(st_v, st_1)
    assert counters.launches > before[0]
    assert recon.delta_rebuild.launches > before[1]
