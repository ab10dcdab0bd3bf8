"""Checkpoint/resume for streaming database scans: the port's copy of
``uvaia_tpu/utils/checkpoint.py``, in the same file format, so either
package resumes the other's snapshot.

The reference has no resume path (SURVEY.md §5): a killed multi-hour
scan only keeps its partial .aln.xz dump.  Here the full scan state —
per-query top-k score/index arrays, the dumped-name map, stream
counters — is snapshotted periodically so a scan over millions of
genomes can resume exactly where it stopped.  The .aln.xz dump stays
valid across restarts because xz streams concatenate (the writer
reopens in append mode, producing a multi-stream file every xz decoder
accepts).

Format: a ``.npz`` archive (arrays + one JSON metadata string), loaded
with ``allow_pickle=False`` — resuming from a tampered checkpoint file
can fail, but can never execute code.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile
from dataclasses import dataclass

import numpy as np

_VERSION = 2


@dataclass
class ScanCheckpoint:
    version: int
    records_read: int          # raw records consumed from the stream
    base_idx: int              # accepted (scored) reference count
    n_invalid: int
    same_name: int
    n_written: int             # sequences already in the .aln dump
    state_scores: np.ndarray   # (Q, k, 6)
    state_idx: np.ndarray      # (Q, k)
    names: dict[int, str]
    config_key: str            # guards against resuming a different run
    dump_bytes: int = 0        # size of the .aln dump at snapshot time;
                               # resume truncates back to it so a crash
                               # mid-xz-stream cannot corrupt the file


def config_key(**kwargs) -> str:
    return json.dumps(kwargs, sort_keys=True)


def save(path: str, ckpt: ScanCheckpoint) -> None:
    """Atomic write (tmp + rename) so a crash never corrupts it."""
    meta = dict(
        version=_VERSION, records_read=ckpt.records_read,
        base_idx=ckpt.base_idx, n_invalid=ckpt.n_invalid,
        same_name=ckpt.same_name, n_written=ckpt.n_written,
        names={str(k): v for k, v in ckpt.names.items()},
        config_key=ckpt.config_key, dump_bytes=ckpt.dump_bytes)
    buf = io.BytesIO()
    np.savez(buf, state_scores=ckpt.state_scores, state_idx=ckpt.state_idx,
             meta=np.asarray(json.dumps(meta)))
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt.")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(buf.getvalue())
            # fsync before rename: on journaled filesystems the rename
            # can commit before the data pages, and a power loss would
            # leave an empty file at the checkpoint path
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        try:
            dfd = os.open(d, os.O_RDONLY)
            os.fsync(dfd)
            os.close(dfd)
        except OSError:
            pass      # directory fsync is best-effort (not all FSs)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str) -> ScanCheckpoint | None:
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("version") != _VERSION:
                raise ValueError(f"version {meta.get('version')}")
            return ScanCheckpoint(
                version=meta["version"],
                records_read=int(meta["records_read"]),
                base_idx=int(meta["base_idx"]),
                n_invalid=int(meta["n_invalid"]),
                same_name=int(meta["same_name"]),
                n_written=int(meta["n_written"]),
                state_scores=z["state_scores"],
                state_idx=z["state_idx"],
                names={int(k): v for k, v in meta["names"].items()},
                config_key=meta["config_key"],
                dump_bytes=int(meta["dump_bytes"]))
    except (KeyError, ValueError, OSError, zipfile.BadZipFile,
            json.JSONDecodeError) as e:
        raise SystemExit(f"unrecognised checkpoint file {path}: {e}")
