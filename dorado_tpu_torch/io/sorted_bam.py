"""Sorted BAM output with bounded memory (port of
``dorado_tpu/io/sorted_bam.py``).


Reproduces HtsFile's sort_bam mode (hts_utils/hts_file.h:16-102 +
hts_file.cpp): records accumulate in a bounded buffer keyed by
``(tid << 32) | pos``; when the buffer fills, a coordinate-sorted run is
flushed to a temp BAM, and `close` k-way-merges the runs into the final
file (the FileMergeBatcher role — here a single heap merge, since Python's
heapq handles arbitrary fan-in without recursive merge batches).
"""

from __future__ import annotations

import heapq
import os
import tempfile
from pathlib import Path
from typing import BinaryIO

from dorado_tpu_torch.io.bam_reader import iter_bam
from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamRecord

UNMAPPED_TID = (1 << 31) - 1  # unmapped records sort last


def sorting_key(rec: SamRecord, ref_order: dict[str, int]) -> int:
    """(tid << 32) | pos (hts_file.cpp:160-162)."""
    tid = ref_order.get(rec.rname, UNMAPPED_TID)
    pos = max(rec.pos - 1, 0)
    return (tid << 32) | pos


class SortedBamWriter:
    """Drop-in BamWriter producing coordinate-sorted output, spilling sorted
    runs to temp files when more than `max_buffered` records are pending."""

    def __init__(
        self,
        fileobj: BinaryIO,
        header: SamHeader,
        max_buffered: int = 100_000,
        tmp_dir: str | None = None,
        index_path: str | Path | None = None,
    ):
        header.sort_order = "coordinate"
        self._fileobj = fileobj
        self._header = header
        # the reference writes <out>.bai alongside every sorted BAM
        # (hts_file.cpp:446-509); index_path enables the same here
        self._index_path = Path(index_path) if index_path else None
        self._ref_order = {name: i for i, (name, _) in enumerate(header.references)}
        self._max_buffered = max_buffered
        self._buffer: list[tuple[int, int, SamRecord]] = []
        self._seq = 0  # stable tiebreak across the whole stream
        self._temp_files: list[Path] = []
        self._tmp_dir = tmp_dir

    def write(self, rec: SamRecord) -> None:
        self._buffer.append((sorting_key(rec, self._ref_order), self._seq, rec))
        self._seq += 1
        if len(self._buffer) >= self._max_buffered:
            self._flush_run()

    def _flush_run(self) -> None:
        if not self._buffer:
            return
        self._buffer.sort(key=lambda kv: kv[:2])
        fd, path = tempfile.mkstemp(suffix=".tmp.bam", dir=self._tmp_dir)
        with os.fdopen(fd, "wb") as fh:
            w = BamWriter(fh, self._header)
            for _, _, rec in self._buffer:
                w.write(rec)
            w.close()
        self._temp_files.append(Path(path))
        self._buffer.clear()

    def _finish(self, out: BamWriter) -> None:
        out.close()
        if self._index_path is not None:
            with open(self._index_path, "wb") as fh:
                out.write_index(fh)

    def close(self) -> None:
        out = BamWriter(
            self._fileobj, self._header, index=self._index_path is not None
        )
        if not self._temp_files:
            # everything fit in memory: plain sort + write
            self._buffer.sort(key=lambda kv: kv[:2])
            for _, _, rec in self._buffer:
                out.write(rec)
            self._finish(out)
            return
        self._flush_run()

        def run_iter(path: Path, run_idx: int):
            # stream one record at a time: peak memory at merge is one
            # in-flight record per run, not the whole dataset
            for rec in iter_bam(path):
                yield sorting_key(rec, self._ref_order), run_idx, rec

        for _, _, rec in heapq.merge(
            *[run_iter(p, i) for i, p in enumerate(self._temp_files)],
            key=lambda kir: kir[:2],
        ):
            out.write(rec)
        self._finish(out)
        for p in self._temp_files:
            try:
                p.unlink()
            except OSError:
                pass
        self._temp_files.clear()
