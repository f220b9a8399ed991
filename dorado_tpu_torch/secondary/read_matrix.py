"""Read-level feature matrix for the secondary model zoo.

Parity with the medaka-style read-alignment encoder
(dorado/secondary/features/medaka_read_matrix.cpp:257-680 +
encoder_read_alignment.cpp:449-475): per (position, read) rows carry
[BASE, QUAL, STRAND, MAPQ] where base ∈ {0: padding, 1..4: ACGT,
5: deletion}, qual is raw phred (-1 at deletions), strand ∈ {-1, +1}
(0 padding), over the same expanded (major, minor) position axis as the
counts pileup.

Optional extra columns ride after the base four, in the reference's
order dwell, haplotag, snp_qv (medaka_read_matrix.cpp:558-568
``include_dwells + include_haplotype_column + include_snp_qv``); dwell is
the per-base value from the read's move table, haplotag and snp_qv are
per-read constants broadcast along the read's aligned span.

Port of ``dorado_tpu/secondary/read_matrix.py``, line for line.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dorado_tpu_torch.secondary.features import calculate_dwells, compute_snp_qv
from dorado_tpu_torch.secondary.pileup import _CIGAR_RE, AlignedRead

BASE_TO_NUM = {"A": 1, "C": 2, "G": 3, "T": 4}
DEL_VAL = 5
NUM_FEATURES = 4  # base, qual, strand, mapq


@dataclass
class ReadMatrixResult:
    matrix: np.ndarray  # [P, D, 4] float32
    positions_major: np.ndarray
    positions_minor: np.ndarray


def build_read_matrix(
    reads: list[AlignedRead],
    region_start: int,
    region_end: int,
    quals: list[np.ndarray] | None = None,
    mapqs: list[int] | None = None,
    max_reads: int = 100,
    include_dwells: bool = False,
    include_haplotags: bool = False,
    include_snp_qv: bool = False,
    haplotags: dict[int, int] | None = None,
) -> ReadMatrixResult:
    """Returns the [positions, reads, features] tensor consumed by
    LatentSpaceLSTM / SlotAttentionConsensus / VariantPerceiver.

    ``haplotags`` ({read index: 1|2}, e.g. from
    ``features.local_haplotags``) overrides per-read ``AlignedRead.haplotag``
    (the HP-tag source) when given."""
    n_major = region_end - region_start
    max_ins = np.zeros(n_major, dtype=np.int64)
    parsed = []
    for read in reads:
        ops = [(int(n), op) for n, op in _CIGAR_RE.findall(read.cigar)]
        parsed.append(ops)
        rpos = read.ref_start
        for n, op in ops:
            if op in "M=XDN":
                rpos += n
            elif op == "I":
                idx = rpos - 1 - region_start
                if 0 <= idx < n_major:
                    max_ins[idx] = max(max_ins[idx], n)

    offsets = np.zeros(n_major + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(1 + max_ins)
    total = int(offsets[-1])
    positions_major = np.zeros(total, dtype=np.int64)
    positions_minor = np.zeros(total, dtype=np.int64)
    for i in range(n_major):
        lo, hi = offsets[i], offsets[i + 1]
        positions_major[lo:hi] = region_start + i
        positions_minor[lo:hi] = np.arange(hi - lo)

    depth = min(len(reads), max_reads)
    n_features = NUM_FEATURES + include_dwells + include_haplotags + include_snp_qv
    matrix = np.zeros((total, max(depth, 1), n_features), dtype=np.float32)

    for read_i, (read, ops) in enumerate(zip(reads, parsed)):
        if read_i >= max_reads:
            break
        strand = -1.0 if read.is_reverse else 1.0
        if mapqs is not None:
            mapq = float(mapqs[read_i])
        else:
            mapq = float(read.mapq)
        qual = quals[read_i] if quals is not None else read.qual

        extra_const = []
        if include_haplotags:
            if haplotags is not None:
                hap = float(haplotags.get(read_i, 0))
            else:
                hap = float(read.haplotag)
            extra_const.append(hap)
        if include_snp_qv:
            extra_const.append(float(compute_snp_qv(read.cigar, read.nm)))
        dwells = None
        if include_dwells:
            dwells = calculate_dwells(read.moves, len(read.seq), read.is_reverse)
            if dwells is None:  # BAD_ALIGNMENT: empty dwell column
                dwells = np.zeros(len(read.seq), dtype=np.int8)

        def put_base(p, q_idx):
            base = BASE_TO_NUM.get(read.seq[q_idx], 0)
            q = float(qual[q_idx]) if qual is not None and len(qual) else 40.0
            row = [base, q, strand, mapq]
            if dwells is not None:
                row.append(float(dwells[q_idx]))
            matrix[p, read_i] = row + extra_const

        def put_del(p):
            row = [DEL_VAL, -1.0, strand, mapq]
            if dwells is not None:
                row.append(0.0)
            matrix[p, read_i] = row + extra_const

        rpos = read.ref_start
        qpos = 0
        for n, op in ops:
            if op in "M=X":
                for j in range(n):
                    idx = rpos + j - region_start
                    if 0 <= idx < n_major:
                        put_base(offsets[idx], qpos + j)
                rpos += n
                qpos += n
            elif op == "I":
                anchor = rpos - 1 - region_start
                if 0 <= anchor < n_major:
                    for j in range(n):
                        p = offsets[anchor] + 1 + j
                        if p < offsets[anchor + 1]:
                            put_base(p, qpos + j)
                qpos += n
            elif op in "DN":
                for j in range(n):
                    idx = rpos + j - region_start
                    if 0 <= idx < n_major:
                        put_del(offsets[idx])
                rpos += n
            elif op == "S":
                qpos += n

        # spanning reads record deletions at minor columns they skip
        # (medaka_read_matrix.cpp:621-650)
        read_end = rpos
        for i in range(n_major):
            lo, hi = offsets[i], offsets[i + 1]
            if hi - lo > 1 and read.ref_start <= region_start + i < read_end:
                for p in range(lo + 1, hi):
                    if matrix[p, read_i, 0] == 0:
                        put_del(p)

    return ReadMatrixResult(
        matrix=matrix,
        positions_major=positions_major,
        positions_minor=positions_minor,
    )
