"""The port's path needs no jax and nothing of the JAX package: in a
process where importing jax, jaxlib or any `uvaia_tpu` module raises,
the package imports, `python -m uvaia_tpu_torch nearest --device cpu
--keep_resolved` (in full mode and with --acgt), sharded over a 2 x 2
CPU mesh (`--devices 4 --site-shards 2`) and with `--num-hosts 1`,
`python -m uvaia_tpu_torch align --device cpu`, the `ball` and `legacy` commands,
`ingest`, `info --verify` and `cluster` (from the store it wrote and
from the FASTA, with the same bytes) run to exit 0, and chip_smoke
imports; and no source file of
the port (nor chip_smoke.py, nor the port's scripts) holds an import
statement of `uvaia_tpu`."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_nearest import random_seqs, write_fasta

ROOT = Path(__file__).resolve().parent.parent

_CHILD = r"""
import importlib.abc
import runpy
import sys


BLOCKED = ("jax", "jaxlib", "uvaia_tpu")


class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, NoJax())
sys.path.insert(0, sys.argv[1])

import uvaia_tpu_torch  # noqa: F401,E402

for argv in (["nearest", "-r", "db.fa", "q.fa", "-n", "3", "-p", "8",
              "--keep_resolved", "--device", "cpu", "-o", "nojax"],
             ["nearest", "-r", "db.fa", "q.fa", "-n", "3", "-p", "8",
              "--keep_resolved", "--acgt", "--device", "cpu", "-o",
              "nojax_acgt"],
             ["nearest", "-r", "db.fa", "q.fa", "-n", "3", "-p", "8",
              "--devices", "4", "--site-shards", "2", "--device", "cpu",
              "-o", "nojax_mesh"],
             ["nearest", "-r", "db.fa", "q.fa", "-n", "3", "-p", "8",
              "--num-hosts", "1", "--device", "cpu", "-o", "nojax_hosts"],
             ["align", "-r", "ref.fa", "q_al.fa", "--device", "cpu", "-o",
              "nojax"],
             ["ball", "-r", "db.fa", "q.fa", "-d", "20", "-p", "8",
              "--device", "cpu", "-o", "nojax_ball"],
             ["legacy", "-r", "db.fa", "q.fa", "-n", "2", "--device", "cpu",
              "-o", "nojax_legacy"],
             ["ingest", "db.fa", "-o", "nojax.uvst", "--block", "8"],
             ["info", "nojax.uvst", "--verify"],
             ["cluster", "nojax.uvst", "-d", "30", "-p", "8", "--device",
              "cpu", "-o", "nojax_cluster"],
             ["cluster", "db.fa", "-d", "30", "-p", "8", "--device", "cpu",
              "-o", "nojax_cluster_fa"]):
    sys.argv = ["uvaia_tpu_torch", *argv]
    try:
        runpy.run_module("uvaia_tpu_torch", run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            raise
import chip_smoke  # noqa: F401,E402

loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("NOJAX-OK")
"""


def test_port_runs_without_jax(tmp_path):
    rng = np.random.default_rng(12)
    L = 250
    qs = random_seqs(rng, 3, L)
    qs.append(qs[0][:50] + "N" * 20 + qs[0][70:])   # redundant query
    write_fasta(tmp_path / "q.fa", [f"q{i}" for i in range(len(qs))], qs)
    write_fasta(tmp_path / "db.fa", [f"r{i}" for i in range(20)],
                random_seqs(rng, 20, L))
    # align: a reference and three unaligned queries (SNP, deletion,
    # insertion)
    ref = qs[1].replace("-", "A").replace("N", "C")
    write_fasta(tmp_path / "ref.fa", ["ref"], [ref])
    write_fasta(tmp_path / "q_al.fa", ["a0", "a1", "a2"],
                ["G" + ref[1:], ref[:100] + ref[103:],
                 ref[:60] + "TTAG" + ref[60:]])
    r = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX-OK" in r.stdout
    assert "after removing 1 redundant sequences" in r.stderr
    assert (tmp_path / "nojax.csv.xz").exists()
    assert (tmp_path / "nojax_acgt.csv.xz").exists()
    assert "Considering ACGT differences only" in r.stderr
    assert "Sharded scan over mesh (db=2, site=2)" in r.stderr
    assert (tmp_path / "nojax_mesh.csv.xz").read_bytes() == \
        (tmp_path / "nojax_hosts.csv.xz").read_bytes()
    assert "Total: 3 read, 3 aligned" in r.stderr
    assert (tmp_path / "nojax.aln.xz").exists()
    assert "Radius search: 3 queries, radius 20" in r.stderr
    assert (tmp_path / "nojax_ball.aln.xz").exists()
    assert r.stdout.count("\n") > 1 + 3 * 2          # the legacy table
    assert (tmp_path / "nojax_legacy.fa.xz").exists()
    assert "Ingested 20 sequences x 250 sites" in r.stderr
    assert "verify           OK: 3 blocks checked" in r.stdout
    for f in ("nojax_cluster.csv.xz", "nojax_cluster.aln.xz"):
        assert (tmp_path / f).read_bytes() == \
            (tmp_path / f.replace("cluster", "cluster_fa")).read_bytes()


PORT_SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in
                      [*(ROOT / "uvaia_tpu_torch").rglob("*.py"),
                       *(ROOT / "scripts").glob("*_torch.py"),
                       ROOT / "chip_smoke.py"])


def _jax_package_imports(tree: ast.AST) -> list[str]:
    """The `uvaia_tpu` modules named by the import statements of a
    module (relative imports stay inside their own package)."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] == "uvaia_tpu"]
    return found


@pytest.mark.parametrize("rel", PORT_SOURCES)
def test_port_source_imports_nothing_of_jax_package(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    assert _jax_package_imports(tree) == []


def test_import_scan_sees_jax_package_imports():
    """The scan above catches both forms, at any depth."""
    tree = ast.parse("import uvaia_tpu.io.fasta\n"
                     "def f():\n    from uvaia_tpu.core import encoding\n"
                     "from uvaia_tpu_torch.io import fasta\n"
                     "from . import uvaia_tpu\n")
    assert _jax_package_imports(tree) == ["uvaia_tpu.io.fasta",
                                          "uvaia_tpu.core"]
