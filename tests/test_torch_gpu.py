"""The port's CUDA kernels on the card, against their plain PyTorch
versions, and `nearest` on the card against `nearest` on the CPU.

Every test here needs a CUDA GPU and skips without one.  The file
imports no jax, so it also runs where jax is not installed, without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import filecmp

import numpy as np
import pytest
import torch

from uvaia_tpu.core.encoding import encode
from uvaia_tpu_torch.engine import nearest
from uvaia_tpu_torch.engine.query import QueryPack
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


def _pack(rng, Q, L):
    pack = QueryPack(names=[f"q{i}" for i in range(Q)],
                     codes=_codes(rng, Q, L, 0.03), acgt=False, trim=0)
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
@pytest.mark.parametrize("B,Q,A", [(300, 70, 40), (33, 3, 8)])
def test_gpu_corr_matches_plain(cuda_device, B, Q, A):
    rng = np.random.default_rng(B + Q)
    r = torch.from_numpy(rng.integers(0, 16, (B, A)).astype(np.uint8))
    q = torch.from_numpy(rng.integers(0, 16, (Q, A)).astype(np.uint8))
    r, q = r.to(cuda_device), q.to(cuda_device)
    _equal(sk.amb_corr(r, q), sk.amb_corr_plain(r, q))


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
            nbest=7, pool=64, prune=prune, device=dev, output=dev))
    for ext in (".csv.xz", ".aln.xz"):
        assert filecmp.cmp("cuda" + ext, "cpu" + ext, shallow=False)
