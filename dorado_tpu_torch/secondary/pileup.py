"""Pileup count features for polishing.

Parity with the medaka-style counts encoder
(dorado/secondary/features/medaka_counts.cpp, encoder_counts.cpp): 10
feature columns per position — "acgtACGTdD" (lowercase/d = reverse strand,
uppercase/D = forward) — over an expanded (major, minor) position axis where
minor positions carry insertion columns. Features are depth-normalised
(NormaliseType::TOTAL).

Port of ``dorado_tpu/secondary/pileup.py``, line for line: the arrays are
held bit-equal to the JAX package's, since the polish pipeline's window
seams compare their (major, minor) columns exactly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

PILEUP_BASES = "acgtACGTdD"
_BASE_COL_FWD = {b: 4 + i for i, b in enumerate("ACGT")}
_BASE_COL_REV = {b: i for i, b in enumerate("ACGT")}
DEL_FWD = 9
DEL_REV = 8

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class AlignedRead:
    ref_start: int  # 0-based
    cigar: str
    seq: str
    is_reverse: bool
    # optional read-level feature inputs (encoder_read_alignment.cpp):
    qual: object = None  # np.ndarray phred per base, or None
    mapq: int = 60
    qname: str = ""
    moves: object = None  # raw mv:B:c array (stride first), or None
    haplotag: int = 0  # HP tag value (0 = untagged)
    nm: int | None = None  # NM tag (substitution fallback for snp_qv)


@dataclass
class PileupResult:
    counts: np.ndarray  # [P, 10] float32 (normalised) or raw
    positions_major: np.ndarray  # [P] i64 draft coordinate
    positions_minor: np.ndarray  # [P] i64 insertion index (0 = major)
    depth: np.ndarray  # [P] f32


def build_pileup(
    reads: list[AlignedRead],
    region_start: int,
    region_end: int,
    normalise: bool = True,
) -> PileupResult:
    """Counts over [region_start, region_end) of the draft."""
    n_major = region_end - region_start
    # first pass: max insertion length observed after each major position
    max_ins = np.zeros(n_major, dtype=np.int64)
    parsed = []
    for read in reads:
        ops = [(int(n), op) for n, op in _CIGAR_RE.findall(read.cigar)]
        parsed.append(ops)
        rpos = read.ref_start
        for n, op in ops:
            if op in "M=X":
                rpos += n
            elif op in "DN":
                rpos += n
            elif op == "I":
                idx = rpos - 1 - region_start
                if 0 <= idx < n_major:
                    max_ins[idx] = max(max_ins[idx], n)

    # expanded axis: each major position followed by its minor columns
    minor_counts = max_ins
    offsets = np.zeros(n_major + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(1 + minor_counts)
    total = int(offsets[-1])
    positions_major = np.zeros(total, dtype=np.int64)
    positions_minor = np.zeros(total, dtype=np.int64)
    for i in range(n_major):
        lo = offsets[i]
        hi = offsets[i + 1]
        positions_major[lo:hi] = region_start + i
        positions_minor[lo:hi] = np.arange(hi - lo)

    counts = np.zeros((total, 10), dtype=np.float32)

    for read, ops in zip(reads, parsed):
        rpos = read.ref_start
        qpos = 0
        base_col = _BASE_COL_REV if read.is_reverse else _BASE_COL_FWD
        del_col = DEL_REV if read.is_reverse else DEL_FWD
        for n, op in ops:
            if op in "M=X":
                for j in range(n):
                    idx = rpos + j - region_start
                    if 0 <= idx < n_major:
                        col = base_col.get(read.seq[qpos + j])
                        if col is not None:
                            counts[offsets[idx], col] += 1
                rpos += n
                qpos += n
            elif op == "I":
                anchor = rpos - 1 - region_start
                if 0 <= anchor < n_major:
                    for j in range(n):
                        p = offsets[anchor] + 1 + j
                        if p < offsets[anchor + 1]:
                            col = base_col.get(read.seq[qpos + j])
                            if col is not None:
                                counts[p, col] += 1
                qpos += n
            elif op in "DN":
                for j in range(n):
                    idx = rpos + j - region_start
                    if 0 <= idx < n_major:
                        counts[offsets[idx], del_col] += 1
                rpos += n
            elif op == "S":
                qpos += n
            # H and P consume nothing we track

    # reads spanning a minor position without an insertion count as deletions
    # there (medaka semantics: depth at minor positions from spanning reads)
    for i in range(n_major):
        lo, hi = offsets[i], offsets[i + 1]
        if hi - lo > 1:
            major_depth_fwd = counts[lo, 4:8].sum() + counts[lo, DEL_FWD]
            major_depth_rev = counts[lo, 0:4].sum() + counts[lo, DEL_REV]
            for p in range(lo + 1, hi):
                ins_fwd = counts[p, 4:8].sum()
                ins_rev = counts[p, 0:4].sum()
                counts[p, DEL_FWD] += max(0.0, major_depth_fwd - ins_fwd)
                counts[p, DEL_REV] += max(0.0, major_depth_rev - ins_rev)

    depth = counts.sum(axis=1)
    feats = counts
    if normalise:
        feats = counts / np.maximum(depth, 1.0)[:, None]
    return PileupResult(
        counts=feats.astype(np.float32),
        positions_major=positions_major,
        positions_minor=positions_minor,
        depth=depth.astype(np.float32),
    )
