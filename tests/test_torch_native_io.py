"""The port's own native IO library (csrc/host/fasta_io.cpp, built by
uvaia_tpu_torch/io/native.py) against the JAX package's on the same
files: records from raw, gzip and xz FASTA, the query packs and
reference batches built from them, and the sparse-delta encoding of the
codes, with and without trimmed (zero-masked) ends.  A build without
liblzma refuses xz files natively, and the port still reads them, in
Python, to the same records.  Every comparison is exact."""

import gzip
import lzma

import numpy as np
import pytest

import uvaia_tpu.engine.query as jquery
import uvaia_tpu.engine.stream as jstream
from uvaia_tpu.io.fasta import read_fasta as jax_read_fasta
from uvaia_tpu.ops import scan as jscan
from uvaia_tpu_torch.core.encoding import encode
from uvaia_tpu_torch.engine import query as pquery, stream as pstream
from uvaia_tpu_torch.io import fasta as pfasta, native
from uvaia_tpu_torch.ops import host

from test_nearest import random_seqs

L = 600
CODECS = ["raw", "gz", "xz"]
TRIMS = [0, 37]


def _text(rng, n: int, prefix: str) -> bytes:
    """FASTA text with lowercase letters, blanks and CRs inside the
    sequence lines, sequences over several lines and a blank line."""
    out = []
    for i, s in enumerate(random_seqs(rng, n, L)):
        s = "".join(c.lower() if rng.random() < 0.1 else c for c in s)
        lines = [s[j:j + 70] for j in range(0, L, 70)]
        lines[1] = lines[1][:5] + " \t" + lines[1][5:]
        out.append(f">{prefix}{i} some description\r\n" + "\n".join(lines)
                   + "\r\n" + ("\n" if i % 3 == 0 else ""))
    return "".join(out).encode()


def _write(path, text: bytes, codec: str) -> None:
    if codec == "raw":
        path.write_bytes(text)
    elif codec == "gz":
        path.write_bytes(gzip.compress(text))
    else:                       # two concatenated streams, as the writers emit
        half = text.index(b">", len(text) // 2)
        path.write_bytes(lzma.compress(text[:half]) +
                         lzma.compress(text[half:]))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nat")
    rng = np.random.default_rng(8)
    q, db = _text(rng, 6, "q"), _text(rng, 45, "r")
    out = {}
    for codec in CODECS:
        qp, dbp = d / f"q.{codec}", d / f"db.{codec}"
        _write(qp, q, codec)
        _write(dbp, db, codec)
        out[codec] = (str(qp), str(dbp))
    return out


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("g++ cannot build the native library here")
    return lib


@pytest.fixture(scope="module")
def lib_no_xz(tmp_path_factory, lib):
    path = native.build(tmp_path_factory.mktemp("noxz") / "lib.so",
                        xz=False)
    return native.load(path)


def _records(it):
    return [(r.name, r.seq) if hasattr(r, "name") else tuple(r) for r in it]


def _batches(streamer):
    return [(b.codes[: b.n].copy(), list(b.names), b.base_idx)
            for b in streamer]


@pytest.mark.parametrize("trim", TRIMS)
@pytest.mark.parametrize("codec", CODECS)
def test_native_reader_matches_jax(files, lib, codec, trim):
    assert codec == "raw" or codec in native.codecs(lib)
    for path in files[codec]:
        want = _records(jax_read_fasta(path))
        assert _records(native.read_fasta_native(path)) == want
        assert _records(pfasta.read_fasta(path)) == want
    qp, dbp = files[codec]
    a = pquery.build_query_pack(qp, trim=trim)
    b = jquery.build_query_pack(qp, trim=trim)
    assert a.names == b.names
    for f in ("codes", "consensus", "poly", "idx_c", "idx_m", "idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    got = _batches(pstream.RefStreamer([dbp], L, 16))
    want = _batches(jstream.RefStreamer([dbp], L, 16))
    assert len(got) == len(want) == 3
    for (gc, gn, gi), (wc, wn, wi) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        assert (gn, gi) == (wn, wi)


@pytest.mark.parametrize("trim", TRIMS)
@pytest.mark.parametrize("codec", CODECS)
def test_native_delta_encoder_matches_jax(files, lib, codec, trim):
    """The port's native delta encoder (ufa_delta_extract/repack) gives
    the JAX package's delta_encode bytes; trimmed ends are zero runs, so
    the run markers are taken."""
    assert host._delta_lib() is lib
    codes = np.stack([encode(s) for _, s in
                      native.read_fasta_native(files[codec][1])])
    base = host.majority_code(codes[:8])
    if trim:
        codes[:, :trim] = 0
        codes[:, L - trim:] = 0
    ok = np.ones(len(codes), dtype=bool)
    ok[4] = False
    got, want = host.delta_encode(codes, ok, base), \
        jscan.delta_encode(codes, ok, base)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert bool((got[1] >= 16).any()) == bool(trim)


@pytest.mark.parametrize("trim", TRIMS)
def test_build_without_lzma_reads_xz_in_python(files, lib_no_xz,
                                               monkeypatch, trim):
    assert native.codecs(lib_no_xz) == ["gz"]
    qp, dbp = files["xz"]
    with pytest.raises(RuntimeError):
        next(native.read_fasta_native(dbp, lib=lib_no_xz))
    # the native library still reads gzip and raw files
    assert _records(native.read_fasta_native(files["gz"][1],
                                             lib=lib_no_xz)) == \
        _records(jax_read_fasta(files["gz"][1]))
    monkeypatch.setattr(native, "_lib", lib_no_xz)
    assert _records(pfasta.read_fasta(dbp)) == _records(jax_read_fasta(dbp))
    a = pquery.build_query_pack(qp, trim=trim)
    b = jquery.build_query_pack(qp, trim=trim)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.consensus, b.consensus)
    got = _batches(pstream.RefStreamer([dbp], L, 16))
    want = _batches(jstream.RefStreamer([dbp], L, 16))
    for (gc, gn, gi), (wc, wn, wi) in zip(got, want, strict=True):
        np.testing.assert_array_equal(gc, wc)
        assert (gn, gi) == (wn, wi)
