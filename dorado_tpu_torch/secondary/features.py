"""Read-level auxiliary features for the polish/variant encoders.

Three feature sources the reference computes per aligned read
(dorado/secondary/features/medaka_read_matrix.cpp,
encoder_read_alignment.cpp):

- **dwell**: per-base signal dwell (number of raw samples between
  successive basecaller moves), decoded from the BAM ``mv:B:c`` tag
  (medaka_read_matrix.cpp:72-140 ``calculate_dwells``).
- **snp_qv**: a per-read phred score of the read's substitution accuracy
  against the draft, from CIGAR op counts (+ NM when the CIGAR uses ``M``)
  (medaka_read_matrix.cpp:162-166 ``compute_snp_qv``,
  hts_utils/bam_utils.cpp:331-355 ``compute_accuracy_from_cigar``).
- **haplotag**: a small local phasing pass that partitions the window's
  reads into two haplotypes from heterozygous SNP candidates — the role of
  kadayashi's ``kadayashi_phase_and_varcall_wrapper``
  (secondary/features/encoder_read_alignment.cpp:292-331,
  3rdparty/kadayashi/src/haplotag_lib/local_haplotagging.cpp:2393; the
  variant-graph machinery is replaced by an iterative 2-cluster allele
  partition). ``HP`` BAM tags are honoured when present
  (HaplotagSource::BAM_HAP_TAG, medaka_read_matrix.cpp:299-327).

Port of ``dorado_tpu/secondary/features.py``, line for line.
"""

from __future__ import annotations

import math
import re

import numpy as np

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def calculate_dwells(moves, seq_len: int, is_reverse: bool) -> np.ndarray | None:
    """Per-base dwells from the raw ``mv`` tag array (stride first, then the
    per-sample move flags). Mirrors medaka_read_matrix.cpp:72-140: reverse
    alignments walk the move table backwards (the last move is the first
    base); forward alignments skip the leading always-1 move and attribute
    the trailing samples to the final base. Returns int8 [seq_len]
    (clamped at 127), zeros when there is no tag, or None on a
    length-inconsistent table (BAD_ALIGNMENT)."""
    out = np.zeros(seq_len, dtype=np.int8)
    if moves is None:
        return out  # NO_DWELL_TAG: empty column, matrix row still added
    mv = np.asarray(moves, dtype=np.int64)
    mv_len = len(mv)
    qpos = 0
    if is_reverse:
        dwell = 0
        for i in range(mv_len - 1, 0, -1):
            dwell += 1
            if mv[i] == 1:
                if qpos >= seq_len:
                    return None
                out[qpos] = min(dwell, 127)
                qpos += 1
                dwell = 0
    else:
        dwell = 1
        for i in range(2, mv_len):
            if mv[i] == 1:
                if qpos >= seq_len:
                    return None
                out[qpos] = min(dwell, 127)
                qpos += 1
                dwell = 0
            dwell += 1
        if qpos >= seq_len:
            return None
        out[qpos] = min(dwell, 127)
    return out


def compute_snp_qv(cigar: str, nm: int | None = None) -> int:
    """Phred of (1 - substitutions/matches). With an =/X CIGAR the
    substitution count is exact; with an ``M`` CIGAR it falls back to
    ``NM - insertions - deletions``. Mirrors compute_accuracy_from_cigar
    (bam_utils.cpp:331-355) + compute_logprob (medaka_read_matrix.cpp:155-158,
    capped at phred 60)."""
    matches = ins = dels = subs = 0
    has_eq = False
    for n, op in _CIGAR_RE.findall(cigar):
        n = int(n)
        if op in "M=":
            matches += n
            has_eq = has_eq or op == "="
        elif op == "X":
            matches += n
            subs += n
            has_eq = True
        elif op == "I":
            ins += n
        elif op in "DN":
            dels += n
    if matches <= 0:
        return 0
    if not has_eq:
        subs = max(0, (nm or 0) - ins - dels)
    acc = min(max(1.0 - subs / matches, 0.0), 1.0)
    err = 1.0 - acc
    if err <= 0.0:
        return 60
    return int(round(min(-10.0 * math.log10(err), 60.0)))


# ---------------------------------------------------------------------------
# local haplotagging (kadayashi-equivalent)
# ---------------------------------------------------------------------------


def _read_alleles(read, region_start: int, region_end: int) -> dict[int, str]:
    """{draft position: base} over aligned M/=/X columns."""
    alleles: dict[int, str] = {}
    rpos, qpos = read.ref_start, 0
    for n, op in _CIGAR_RE.findall(read.cigar):
        n = int(n)
        if op in "M=X":
            lo = max(rpos, region_start)
            hi = min(rpos + n, region_end)
            for p in range(lo, hi):
                alleles[p] = read.seq[qpos + (p - rpos)]
            rpos += n
            qpos += n
        elif op == "I":
            qpos += n
        elif op in "DN":
            rpos += n
        elif op == "S":
            qpos += n
    return alleles


def local_haplotags(
    reads,
    region_start: int,
    region_end: int,
    min_depth: int = 4,
    min_alt_frac: float = 0.2,
    max_iters: int = 10,
) -> dict[int, int]:
    """Partition the window's reads into two haplotypes.

    Functional equivalent of kadayashi's local phasing
    (local_haplotagging.cpp kadayashi_phase_and_varcall_wrapper): find
    biallelic heterozygous SNP candidates (both alleles ≥ ``min_alt_frac``
    of a column with depth ≥ ``min_depth``), then iteratively refine a
    2-way read partition against per-haplotype allele consensus (k-means
    style, seeded by the highest-depth candidate column). Returns
    {read index: 1 | 2}; reads carrying no informative allele are absent
    (haplotag 0 / untagged).
    """
    allele_maps = [_read_alleles(r, region_start, region_end) for r in reads]

    # candidate het columns
    by_pos: dict[int, dict[str, int]] = {}
    for am in allele_maps:
        for p, b in am.items():
            if b in "ACGT":
                by_pos.setdefault(p, {}).setdefault(b, 0)
                by_pos[p][b] += 1
    candidates: dict[int, tuple[str, str]] = {}
    for p, counts in by_pos.items():
        depth = sum(counts.values())
        if depth < min_depth:
            continue
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:2]
        if len(top) < 2:
            continue
        (b1, c1), (b2, c2) = top
        if c2 / depth >= min_alt_frac and c1 / depth >= min_alt_frac:
            candidates[p] = (b1, b2)
    if not candidates:
        return {}

    # read × candidate allele codes: 0 = allele1, 1 = allele2, -1 = n/a
    cand_pos = sorted(candidates)
    codes = np.full((len(reads), len(cand_pos)), -1, dtype=np.int8)
    for i, am in enumerate(allele_maps):
        for j, p in enumerate(cand_pos):
            b = am.get(p)
            if b == candidates[p][0]:
                codes[i, j] = 0
            elif b == candidates[p][1]:
                codes[i, j] = 1

    # seed: split on the deepest candidate column
    depths = (codes >= 0).sum(axis=0)
    seed = int(np.argmax(depths))
    assign = np.where(codes[:, seed] == 0, 1, np.where(codes[:, seed] == 1, 2, 0))

    for _ in range(max_iters):
        # per-haplotype consensus allele at each candidate
        cons = np.full((2, len(cand_pos)), -1, dtype=np.int8)
        for h in (1, 2):
            sub = codes[assign == h]
            if len(sub) == 0:
                continue
            for j in range(len(cand_pos)):
                col = sub[:, j][sub[:, j] >= 0]
                if len(col):
                    cons[h - 1, j] = 1 if col.mean() > 0.5 else 0
        new_assign = np.zeros_like(assign)
        for i in range(len(reads)):
            informative = codes[i] >= 0
            if not informative.any():
                continue
            scores = []
            for h in (0, 1):
                valid = informative & (cons[h] >= 0)
                scores.append(
                    (codes[i][valid] == cons[h][valid]).sum() - (valid.sum() / 2)
                )
            if scores[0] == scores[1]:
                new_assign[i] = assign[i]
            else:
                new_assign[i] = 1 if scores[0] > scores[1] else 2
        if (new_assign == assign).all():
            break
        assign = new_assign

    return {i: int(h) for i, h in enumerate(assign) if h in (1, 2)}
