"""The port's command line maps errors to uvaia_tpu's exit codes, for
every subcommand: a file that cannot be opened or written exits 2, an
interrupt 130, a closed output pipe a quiet 0."""

import errno
import os
import sys

import numpy as np
import pytest

import uvaia_tpu.engine.align as jalign
import uvaia_tpu.engine.nearest as jnearest
import uvaia_tpu.io.fasta as fasta_mod
import uvaia_tpu_torch.io.fasta as port_fasta_mod
from uvaia_tpu.cli.main import main as jax_main
from uvaia_tpu_torch.cli import main as port_main
from uvaia_tpu_torch.engine import align as palign, nearest as pnearest

from test_gotoh import rand_dna
from test_nearest import random_seqs, write_fasta

ARGV = {
    "align": ["align", "-r", "ref.fa", "q.fa"],
    "nearest": ["nearest", "-r", "db.fa", "q.fa", "-n", "2", "-p", "8"],
}
ENGINES = {"align": (jalign, palign, "run_align"),
           "nearest": (jnearest, pnearest, "run_nearest")}


def _files():
    rng = np.random.default_rng(3)
    ref = rand_dna(rng, 200).decode()
    with open("ref.fa", "w") as f:
        f.write(f">r\n{ref}\n")
    write_fasta("q.fa", ["q0", "q1"], [ref, ref[:90] + "A" + ref[91:]])
    write_fasta("db.fa", [f"r{i}" for i in range(10)],
                random_seqs(rng, 10, 200))


@pytest.mark.parametrize("cmd", ["align", "nearest"])
def test_unwritable_output_prefix_exits_2(tmp_path, monkeypatch, capsys,
                                          cmd):
    """An output prefix in a read-only directory.  A root process may
    write there all the same, so the writer's file opener also refuses
    paths under it, as the file system would (in each package's own
    writer module)."""
    monkeypatch.chdir(tmp_path)
    _files()
    locked = tmp_path / "locked"
    locked.mkdir(mode=0o555)

    def refusing_open(path, *a, **kw):
        if str(path).startswith(str(locked)):
            raise PermissionError(errno.EACCES, os.strerror(errno.EACCES),
                                  str(path))
        return open(path, *a, **kw)

    for mod in (fasta_mod, port_fasta_mod):
        monkeypatch.setattr(mod, "open", refusing_open, raising=False)
    prefix = str(locked / "out")
    assert jax_main(ARGV[cmd] + ["-o", prefix]) == 2
    jax_err = capsys.readouterr().err
    assert port_main(ARGV[cmd] + ["-o", prefix, "--device", "cpu"]) == 2
    port_err = capsys.readouterr().err
    for err in (jax_err, port_err):
        assert f"permission denied: {prefix}" in err
    assert os.listdir(locked) == []


@pytest.mark.parametrize("cmd", ["align", "nearest"])
@pytest.mark.parametrize("exc,code", [
    (PermissionError(errno.EACCES, "Permission denied", "x"), 2),
    (FileNotFoundError(errno.ENOENT, "No such file or directory", "x"), 2),
    (KeyboardInterrupt(), 130),
    (BrokenPipeError(errno.EPIPE, "Broken pipe"), 0)])
def test_exit_codes_match_jax(tmp_path, monkeypatch, cmd, exc, code):
    monkeypatch.chdir(tmp_path)
    _files()

    def boom(*a, **kw):
        raise exc

    jmod, pmod, fn = ENGINES[cmd]
    monkeypatch.setattr(jmod, fn, boom)
    monkeypatch.setattr(pmod, fn, boom)
    # the BrokenPipeError branch points stdout at devnull: keep the real
    # descriptor and put it back
    fd = sys.stdout.fileno()
    saved = os.dup(fd)
    try:
        assert jax_main(ARGV[cmd]) == code
        assert port_main(ARGV[cmd] + ["--device", "cpu"]) == code
    finally:
        os.dup2(saved, fd)
        os.close(saved)
