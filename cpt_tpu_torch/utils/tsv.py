"""Seekable TSV + .lineidx IO (the port's copy of the parts of
``cpt_tpu/utils/tsv.py`` that the task paths use).

Bit-compatible with the reference's TSV interchange format, the only
interface between the detector stage and the VL stage: a plain
tab-separated file plus a sibling ``<name>.lineidx`` holding one decimal
byte offset per row, so row ``i`` is read with a single seek. Feature rows
are ``key \\t json`` where the json embeds base64-encoded little-endian
float32 region features (:func:`encode_feature` / :func:`decode_feature`).

The lineidx scan is the pure-Python one; the JAX package's optional native
scanner and batch decoder are not carried over.
"""
from __future__ import annotations

import base64
import os
import os.path as op
from typing import Iterable, List, Optional, Sequence

import numpy as np


def lineidx_path(tsv_path: str) -> str:
    return op.splitext(tsv_path)[0] + ".lineidx"


class TSVFile:
    """Random-access reader over a TSV file via its .lineidx sidecar, which
    is generated on first use if absent."""

    def __init__(self, tsv_path: str):
        self.tsv_path = tsv_path
        self.lineidx = lineidx_path(tsv_path)
        self._fp = None
        self._offsets: Optional[List[int]] = None
        if not op.isfile(self.lineidx):
            _generate_lineidx(tsv_path, self.lineidx)

    def __len__(self) -> int:
        self._ensure_offsets()
        return len(self._offsets)

    def seek(self, idx: int) -> List[str]:
        self._ensure_offsets()
        if self._fp is None:
            self._fp = open(self.tsv_path, "rb")
        self._fp.seek(self._offsets[idx])
        return self._fp.readline().decode("utf-8").rstrip("\n").split("\t")

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def _ensure_offsets(self) -> None:
        if self._offsets is None:
            with open(self.lineidx) as f:
                self._offsets = [int(line) for line in f if line.strip()]


def _generate_lineidx(tsv_path: str, idx_path: str) -> None:
    offsets = []
    with open(tsv_path, "rb") as f:
        pos = f.tell()
        while f.readline():
            offsets.append(pos)
            pos = f.tell()
    with open(idx_path, "w") as f:
        f.writelines(f"{o}\n" for o in offsets)


def tsv_writer(rows: Iterable[Sequence[str]], tsv_path: str) -> None:
    """Write rows + lineidx atomically (tmp file then rename), mirroring the
    reference's ``tsv_file_ops.tsv_writer`` semantics."""
    os.makedirs(op.dirname(op.abspath(tsv_path)), exist_ok=True)
    idx_path = lineidx_path(tsv_path)
    tsv_tmp, idx_tmp = tsv_path + ".tmp", idx_path + ".tmp"
    with open(tsv_tmp, "wb") as ftsv, open(idx_tmp, "w") as fidx:
        pos = 0
        for row in rows:
            data = ("\t".join(str(c) for c in row) + "\n").encode("utf-8")
            ftsv.write(data)
            fidx.write(f"{pos}\n")
            pos += len(data)
    os.replace(tsv_tmp, tsv_path)
    os.replace(idx_tmp, idx_path)


def merge_tsv_shards(shard_paths: Sequence[str], out_path: str) -> None:
    """Concatenate per-shard TSVs (``extract_features --total_step N
    --cur_step i`` runs) into one file with a fresh lineidx: the explicit
    form of the reference's shard loop (``prompt_feat/tools/cnt.py``,
    ``cmds/gqa/ext.sh``)."""

    def rows():
        for p in shard_paths:
            with open(p, "rb") as f:
                for line in f:
                    yield line.decode("utf-8").rstrip("\n").split("\t")

    tsv_writer(rows(), out_path)


def encode_feature(feat: np.ndarray) -> str:
    """float32 feature vector -> base64 string (reference codec)."""
    return base64.b64encode(np.ascontiguousarray(feat, dtype=np.float32).tobytes()).decode("utf-8")


def decode_feature(b64: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(b64), dtype=np.float32)
