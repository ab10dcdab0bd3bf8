"""`align` end to end: the port (uvaia_tpu_torch, plain versions on the
CPU) against the JAX package (uvaia_tpu) on the same files.

Each scenario of tests/test_align.py runs through both packages' run_align
with the same monkeypatches applied to both; the .aln.xz bytes, every
AlignStats field, the .uncertified.txt sidecar and the --stdout text
must be equal.  The command lines are compared the same way.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

import uvaia_tpu.engine.align as jalign
import uvaia_tpu.ops.gotoh as jgotoh
from uvaia_tpu.cli.main import main as jax_main
from uvaia_tpu.io.fasta import FastaRecord
from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.engine import align as palign
from uvaia_tpu_torch.ops import gotoh as pgotoh

from test_gotoh import rand_dna


def _write(path, recs):
    with open(path, "w") as f:
        for name, seq in recs:
            f.write(f">{name}\n{seq.decode()}\n")


def _mutant(rng, ref, snps=0, indel=0):
    q = bytearray(ref)
    for _ in range(snps):
        q[rng.integers(0, len(q))] = b"ACGT"[int(rng.integers(0, 4))]
    if indel:
        p = int(rng.integers(0, len(q) - abs(indel) - 1))
        if indel < 0:
            del q[p:p - indel]
        else:
            q[p:p] = rand_dna(rng, indel)
    return bytes(q)


# ----------------------------------------------------------------------
# scenarios of tests/test_align.py: each writes ref.fa and its query
# files and returns (query files, AlignConfig fields)


def _end_to_end(rng):
    n = 300
    ref = rand_dna(rng, n)
    q_snp = bytearray(ref)
    q_snp[10] = ord("A") if ref[10] != ord("A") else ord("C")
    _write("ref.fa", [("wuhan", ref)])
    _write("q.fa", [("ident", ref), ("snp", bytes(q_snp)),
                    ("del8", ref[:50] + ref[58:]),
                    ("ins6", ref[:100] + b"ACGTAC" + ref[100:]),
                    ("short", ref[:100]), ("ambig", b"N" * n)])
    return ["q.fa"], dict(pool=4)


def _hybrid(rng):
    ref = rand_dna(rng, 240)
    _write("ref.fa", [("r", ref)])
    _write("q.fa", [(f"q{i}", _mutant(rng, ref, int(rng.integers(0, 8)),
                                      int(rng.integers(-8, 9))))
                    for i in range(24)])
    return ["q.fa"], {}


def _overflow(rng):
    ref = rand_dna(rng, 400)
    qs = []
    for b in range(6):
        q = bytearray(ref)
        for p in (280, 200, 120, 50):   # 4 separate 2-base deletions
            del q[p:p + 2]
        q[10 + b] = b"ACGT"[(ref[10 + b] + 1) % 4]
        qs.append((f"q{b}", bytes(q)))
    _write("ref.fa", [("r", ref)])
    _write("q.fa", qs)
    return ["q.fa"], {}


def _nheavy(rng):
    ref = rand_dna(rng, 400)
    _write("ref.fa", [("r", ref)])
    _write("q.fa", [("nheavy", b"N" * 200 + ref[200:]), ("clean", ref)])
    return ["q.fa"], dict(band=64)


def _chunked(rng):
    ref = rand_dna(rng, 600)
    qs = []
    for i in range(20):
        q = bytearray(ref)
        q[7 + i] = ord("A") if ref[7 + i] != ord("A") else ord("C")
        del q[100:103]
        qs.append((f"q{i}", bytes(q)))
    _write("ref.fa", [("r", ref)])
    _write("q.fa", qs)
    return ["q.fa"], {}


def _multi_file(rng):
    ref = rand_dna(rng, 250)
    _write("ref.fa", [("r", ref)])
    for fi in range(3):
        _write(f"q{fi}.fa", [(f"f{fi}_s{i}", _mutant(rng, ref, 1))
                             for i in range(7)])
    return [f"q{i}.fa" for i in range(3)], dict(pool=4)


def _adversarial(rng):
    n = 3000
    ref = rand_dna(rng, n)
    q = ref[:1000] + rand_dna(rng, 150) + ref[1000:2000] + ref[2150:]
    _write("ref.fa", [("r", ref)])
    _write("q.fa", [("wander", q)])
    return ["q.fa"], {}


def _gap_runs(rng):
    """Gap runs longer than the walks' probes: truncated and extended
    ends, a long deletion and a long insertion inside, both at once; the
    same with the event capacity at 4, so the dense walk retires them."""
    n = 640
    ref = rand_dna(rng, n)
    ins = rand_dna(rng, 150)
    _write("ref.fa", [("r", ref)])
    _write("q.fa", [
        ("cut_start", ref[140:]), ("cut_end", ref[:n - 170]),
        ("cut_both", ref[135:n - 140]), ("long_del", ref[:250] + ref[410:]),
        ("long_ins", ref[:400] + ins + ref[400:]),
        ("lead_ins", ins + ref), ("tail_ins", ref + ins[:140]),
        ("del_and_ins", ref[:150] + ref[290:450] + ins[:135] + ref[450:]),
        ("snps", _mutant(rng, ref, 9))])
    return ["q.fa"], dict(pool=4)


SCENARIOS = {
    # name: (file writer, seed, extra AlignConfig fields, patches)
    "end_to_end": (_end_to_end, 9, {}, {}),
    "hybrid": (_hybrid, 12, {}, {}),
    "overflow": (_overflow, 5, {}, {}),
    "overflow_ev_cap4": (_overflow, 5, {}, {"EV_CAP": 4}),
    "exact_fallback": (_nheavy, 13, {}, {}),
    "uncertified_sidecar": (_nheavy, 13, dict(exact_fallback=False), {}),
    "small_chunk_plan": (_chunked, 31, {}, {"TB_BUDGET": 640 * 256 * 10}),
    "multi_file": (_multi_file, 21, {}, {}),
    "band_edge_adversarial": (_adversarial, 1234, {}, {}),
    "gap_runs": (_gap_runs, 77, {}, {}),
    "gap_runs_dense_walk": (_gap_runs, 77, {}, {"EV_CAP": 1}),
    "gap_runs_narrow_band": (_gap_runs, 77, dict(band=64), {}),
}


def _patch(monkeypatch, patches):
    for name, value in patches.items():
        if name == "EV_CAP":
            monkeypatch.setattr(jgotoh, name, value)
            monkeypatch.setattr(pgotoh, name, value)
        else:
            monkeypatch.setattr(jalign, name, value)
            monkeypatch.setattr(palign, name, value)


def _same_run(prefix_a, prefix_b, stats_a, stats_b):
    assert dataclasses.asdict(stats_a) == dataclasses.asdict(stats_b)
    assert filecmp.cmp(prefix_a + ".aln.xz", prefix_b + ".aln.xz",
                       shallow=False)
    side_a, side_b = (p + ".uncertified.txt" for p in (prefix_a, prefix_b))
    assert os.path.exists(side_a) == os.path.exists(side_b)
    if os.path.exists(side_a):
        assert filecmp.cmp(side_a, side_b, shallow=False)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_align_matches_jax(tmp_path, monkeypatch, name):
    monkeypatch.chdir(tmp_path)
    write, seed, extra, patches = SCENARIOS[name]
    files, kw = write(np.random.default_rng(seed))
    kw.update(extra)
    _patch(monkeypatch, patches)
    sj = jalign.run_align("ref.fa", files, jalign.AlignConfig(
        output="jax", **kw))
    sp = palign.run_align("ref.fa", files, palign.AlignConfig(
        output="port", device="cpu", **kw))
    _same_run("jax", "port", sj, sp)
    assert sp.n_output > 0


def test_stdout_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    files, _ = _hybrid(np.random.default_rng(2))
    sj = jalign.run_align("ref.fa", files, jalign.AlignConfig(to_stdout=True))
    out_j = capsys.readouterr().out
    sp = palign.run_align("ref.fa", files, palign.AlignConfig(
        to_stdout=True, device="cpu"))
    out_p = capsys.readouterr().out
    assert out_p == out_j and out_p.count(">") == 24
    assert dataclasses.asdict(sj) == dataclasses.asdict(sp)


@pytest.mark.parametrize("stdout", [False, True])
def test_cli_matches_jax(tmp_path, monkeypatch, capsys, stdout):
    """`python -m uvaia_tpu_torch align --device cpu` against
    `python -m uvaia_tpu align`: the same bytes."""
    monkeypatch.chdir(tmp_path)
    files, _ = _end_to_end(np.random.default_rng(4))
    extra = ["--stdout"] if stdout else []
    assert jax_main(["align", "-r", "ref.fa", *files, "-p", "2", "-o",
                     "jax", *extra]) == 0
    out_j = capsys.readouterr().out
    assert port_main(["align", "-r", "ref.fa", *files, "-p", "2", "-o",
                      "port", "--device", "cpu", *extra]) == 0
    out_p = capsys.readouterr().out
    assert out_p == out_j
    if not stdout:
        assert filecmp.cmp("jax.aln.xz", "port.aln.xz", shallow=False)


@pytest.mark.parametrize("seqs", [
    [b"ACGTRYKMSWBDHVNA" * 4],                    # 15 distinct values
    [b"ACGTRYKMSWBDHVNU" * 4, b"ACGT" * 8],       # 16, shorter 2nd row
    [bytes(range(65, 91)) + b"ACGTAC"]])          # 26: dense upload
def test_device_batch_matches_jax(seqs):
    ref = np.frombuffer(b"ACGT" * 16, np.uint8)
    recs = [FastaRecord(name=f"x{i}", seq=s) for i, s in enumerate(seqs)]
    jdb = jalign._make_device_batch(ref, recs)
    pdb = palign._make_device_batch(ref, recs, "cpu")
    np.testing.assert_array_equal(pdb.arr_d.numpy(), np.asarray(jdb.arr_d))
    np.testing.assert_array_equal(pdb.lens_d.numpy(), np.asarray(jdb.lens_d))
    for i, s in enumerate(seqs):
        np.testing.assert_array_equal(pdb.arr_d[i, :len(s)].numpy(),
                                      np.frombuffer(s, np.uint8))


@pytest.mark.parametrize("n,width", [
    (29903, 3073), (29903, 129), (29903, 1409), (29903, 15001),
    (200000, 2049), (5_000_000, 641), (29903, 70657)])
def test_chunk_plan_matches_jax(n, width):
    assert palign._chunk_plan(n, width) == jalign._chunk_plan(n, width)
    assert palign._band_levels(width) == jalign._band_levels(width)
    assert (palign._choose_band(n, [n - width, n + 7], 64)
            == jalign._choose_band(n, [n - width, n + 7], 64))


def test_dispatch_group_skips_undispatchable_band():
    n, width = 5_000_000, 641

    class _DB:
        ref_arr = np.zeros(n, dtype=np.uint8)

    rec = FastaRecord(name="big", seq=b"ACGT")
    for mod in (jalign, palign):
        stats = mod.AlignStats()
        assert mod._dispatch_group(_DB(), [(rec, 0)], -320, width,
                                   stats) == []
        assert stats.failed_band == 1


def test_cuda_without_gpu_exits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _end_to_end(np.random.default_rng(1))
    monkeypatch.setattr(palign.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        port_main(["align", "-r", "ref.fa", "q.fa", "-o", "x"])
    assert exc.value.code not in (0, None)
    assert not os.path.exists("x.aln.xz")
