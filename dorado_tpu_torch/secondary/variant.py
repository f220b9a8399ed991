"""Variant calling from polishing model output + VCF writing.

Reference-faithful port of dorado/secondary/consensus/variant_calling.cpp
(general_decode_variants): candidate columns from per-haplotype consensus vs
the gapped draft (consensus_utils.cpp variant_columns), RLE runs ->
construct_variant, left-alignment/trim normalization (normalize_variant),
overlap/adjacent merging (merge_sorted_variants), per-position gVCF
reference records scored from the model's reference probability
(compute_ref_quality), and genotype normalization with the LowQual filter
(normalize_genotype). VCF text output mirrors
dorado/secondary/common/vcf_writer.cpp.

Port of ``dorado_tpu/secondary/variant.py``, line for line: host numpy and
text, on the model's probabilities after they reach the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import TextIO

import numpy as np

from dorado_tpu_torch.secondary.model import SYMBOLS

_SYMBOL_SET = set(SYMBOLS)
_SYMBOL_LOOKUP = np.full(256, -1, dtype=np.int32)
for _i, _s in enumerate(SYMBOLS):
    _SYMBOL_LOOKUP[ord(_s)] = _i
_QV_CAP = 70.0


@dataclass
class Variant:
    contig: str
    pos: int  # 0-based
    ref: str
    alts: list[str]
    qual: float = 0.0
    filter: str = "PASS"
    genotype: list[tuple[str, str]] = field(default_factory=list)
    # pileup-column span of the event (variant_calling.h Variant::rstart/rend)
    rstart: int = 0
    rend: int = 0

    @property
    def is_valid(self) -> bool:
        """variant.cpp:47-63: non-empty ref, non-empty alts, not all
        alts == ref, and no empty alt string."""
        if not self.ref or not self.alts:
            return False
        if all(a == self.ref for a in self.alts):
            return False
        if any(not a for a in self.alts):
            return False
        return True


def _phred(err: float, cap: float = _QV_CAP) -> float:
    """variant_calling.cpp:58-62."""
    err = min(max(err, 10.0 ** (-cap / 10.0)), 1.0)
    return min(-10.0 * np.log10(err), cap)


def _remove_gaps(s: str) -> str:
    return s.replace("*", "")


def _extract_draft_with_gaps(draft: str, pm: np.ndarray, pn: np.ndarray) -> str:
    """Draft expanded over pileup columns, '*' at minor (insert) columns."""
    return "".join("*" if n else draft[m] for m, n in zip(pm, pn))


def _variant_columns(minor: np.ndarray, reference: str, prediction: str) -> np.ndarray:
    """consensus_utils.cpp variant_columns: a major column is a variant iff
    it differs; the minor (insert) columns of a reference position are
    all-or-nothing — marked iff the major or any insert in the run differs."""
    n = len(minor)
    if n == 0:
        return np.zeros(0, dtype=bool)
    ref = np.frombuffer(reference.encode(), dtype=np.uint8)
    pred = np.frombuffer(prediction.encode(), dtype=np.uint8)
    diff = ref != pred
    is_major = np.asarray(minor) == 0
    gid = np.maximum(np.cumsum(is_major) - 1, 0)
    ngroups = int(gid[-1]) + 1
    group_any = np.zeros(ngroups, dtype=bool)
    np.logical_or.at(group_any, gid, diff)
    return np.where(is_major, diff, group_any[gid])


def _find_variants(
    minor: np.ndarray,
    ref_gaps: str,
    cons_gaps: list[str],
    restrict_symbols: bool,
) -> np.ndarray:
    """consensus_utils.cpp find_polyploid_variants: OR over haplotypes; with
    symbol restriction (ambig_ref off) ambiguous-reference columns are never
    variants."""
    ret = np.zeros(len(minor), dtype=bool)
    for hap in cons_gaps:
        ret |= _variant_columns(minor, ref_gaps, hap)
    if restrict_symbols:
        ref = np.frombuffer(ref_gaps.encode(), dtype=np.uint8)
        ret &= _SYMBOL_LOOKUP[ref] >= 0
    return ret


def _run_length_encode(mask: np.ndarray) -> list[tuple[int, int, bool]]:
    if len(mask) == 0:
        return []
    edges = np.flatnonzero(np.diff(mask.astype(np.int8))) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [len(mask)]])
    return [(int(s), int(e), bool(mask[s])) for s, e in zip(starts, ends)]


def _subseq_log_prob(
    probs3: np.ndarray, seq: str, rstart: int, rend: int, hap: int, substitute_n: bool
) -> float:
    """variant_calling.cpp compute_subseq_log_prob."""
    if rend <= rstart:
        return 0.0
    s = seq[rstart:rend]
    if substitute_n:
        s = s.replace("N", "*")
    ids = _SYMBOL_LOOKUP[np.frombuffer(s.encode(), dtype=np.uint8)]
    p = probs3[np.arange(rstart, rend), hap, ids]
    return float(np.log(np.maximum(p, 1e-10)).sum())


def _compute_ref_quality(probs3: np.ndarray, ref_gaps: str, rstart: int, rend: int) -> float:
    """variant_calling.cpp:144-169: max log prob of the reference over
    haplotypes -> phred."""
    best = max(
        _subseq_log_prob(probs3, ref_gaps, rstart, rend, h, True)
        for h in range(probs3.shape[1])
    )
    return max(0.0, _phred(1.0 - float(np.exp(best))))


def _compute_consensus_quality(
    probs3: np.ndarray, cons_gaps: list[str], rstart: int, rend: int
) -> float:
    """variant_calling.cpp:182-216: accumulated log prob of the prediction
    across haplotypes -> phred."""
    total = sum(
        _subseq_log_prob(probs3, cons_gaps[h], rstart, rend, h, False)
        for h in range(probs3.shape[1])
    )
    return max(0.0, _phred(1.0 - float(np.exp(total))))


def _find_previous_ref_pos(pm, pn, rstart: int) -> tuple[bool, int, int]:
    """variant_calling.cpp:409-446."""
    n = len(pm)
    if rstart <= 0 or rstart >= n:
        return False, rstart, -1
    ref_pos = int(pm[rstart])
    prev_ref_pos = ref_pos - 1
    if ref_pos <= 0:
        return False, rstart, ref_pos
    rpos = rstart
    while rpos >= 0 and (
        pm[rpos] > prev_ref_pos or (pm[rpos] == prev_ref_pos and pn[rpos] != 0)
    ):
        rpos -= 1
    if rpos < 0:
        return False, rpos, ref_pos
    if pm[rpos] != prev_ref_pos or pn[rpos] != 0:
        return False, rpos, ref_pos
    return True, rpos, prev_ref_pos


def _find_ref_pos(pm, pn, rstart: int, requested: int) -> tuple[bool, int, int]:
    """variant_calling.cpp:448-477."""
    n = len(pm)
    if requested < 0 or rstart < 0 or rstart >= n:
        return False, -1, -1
    rpos = rstart
    while rpos < n and (
        pm[rpos] < requested or (pm[rpos] == requested and pn[rpos] != 0)
    ):
        rpos += 1
    if rpos >= n:
        return False, rpos, requested
    if pm[rpos] != requested or pn[rpos] != 0:
        return False, rpos, requested
    return True, rpos, requested


def _prepend_ref_base(var, ref_gaps, cons_gaps, pm, pn, ambig_ref) -> bool:
    """variant_calling.cpp:479-537: extend left by one reference base if the
    prefix is identical across ref + all haplotypes (not itself a variant)."""
    can_go_left, new_rstart, _ = _find_previous_ref_pos(pm, pn, var.rstart)
    if not can_go_left:
        return False
    if not ambig_ref and any(
        ref_gaps[i] not in _SYMBOL_SET for i in range(new_rstart, var.rstart)
    ):
        return False
    span = slice(new_rstart, var.rstart)
    prefixes = [ref_gaps[span]] + [seq[span] for seq in cons_gaps]
    if len(set(prefixes)) > 1:
        return False
    prefixes = [_remove_gaps(p) for p in prefixes]
    var.pos = int(pm[new_rstart])
    var.rstart = new_rstart
    var.ref = prefixes[0] + var.ref
    var.alts = [prefixes[i + 1] + a for i, a in enumerate(var.alts)]
    return True


def _append_ref_base(var, ref_gaps, cons_gaps, pm, pn, ambig_ref) -> bool:
    """variant_calling.cpp:539-617: extend right by one reference base if
    the suffix column is identical across ref + all haplotypes."""
    next_ref_pos = var.pos + len(var.ref)
    can_go_right, new_rend_inc, _ = _find_ref_pos(pm, pn, var.rstart, next_ref_pos)
    if not can_go_right:
        return False
    if var.rstart > new_rend_inc:
        return False
    if not ambig_ref and any(
        ref_gaps[i] not in _SYMBOL_SET for i in range(var.rstart, new_rend_inc + 1)
    ):
        return False
    suffixes = {ref_gaps[new_rend_inc]} | {seq[new_rend_inc] for seq in cons_gaps}
    if len(suffixes) > 1:
        return False
    span = slice(var.rstart, new_rend_inc + 1)
    var.ref = _remove_gaps(ref_gaps[span])
    var.alts = [_remove_gaps(seq[span]) for seq in cons_gaps]
    var.rend = new_rend_inc + 1
    return True


def _trim_start(var, rev: bool) -> None:
    """variant_calling.cpp:698-752: trim common leading (or, reversed,
    trailing) bases, never trimming the last base; pos advances by the
    forward trim."""
    seqs = [var.ref] + list(var.alts)
    if rev:
        seqs = [s[::-1] for s in seqs]
    min_len = min(len(s) for s in seqs)
    start_pos = 0
    for i in range(min_len - 1):
        if any(s[i] != seqs[0][i] for s in seqs[1:]):
            break
        start_pos += 1
    if start_pos > 0:
        seqs = [s[start_pos:] for s in seqs]
    if rev:
        seqs = [s[::-1] for s in seqs]
        start_pos = 0
    var.ref = seqs[0]
    var.alts = seqs[1:]
    var.pos += start_pos


def _normalize_variant(ref_gaps, cons_gaps, pm, pn, var, ambig_ref):
    """variant_calling.cpp normalize_variant (:683-919): move the start to a
    major column, right-trim + left-align with ref-base extension, then trim
    common prefix."""
    if all(a == var.ref for a in var.alts):
        return var

    ret = replace(var, alts=list(var.alts))

    # Move rstart to the first major column (left then right).
    new_rstart = ret.rstart
    while new_rstart > 0 and pn[new_rstart] != 0:
        new_rstart -= 1
    if pn[new_rstart] != 0:
        new_rstart = ret.rstart + 1
        while new_rstart < ret.rend and pn[new_rstart] != 0:
            new_rstart += 1
    if new_rstart >= ret.rend:
        return None
    if new_rstart != ret.rstart:
        ret.rstart = new_rstart
        ret.pos = int(pm[ret.rstart])
        span = slice(ret.rstart, ret.rend)
        ret.ref = _remove_gaps(ref_gaps[span])
        ret.alts = [_remove_gaps(s[span]) for s in cons_gaps]

    # trim_end_and_align: right-trim identical last bases; extend with a
    # reference base when any allele becomes empty.
    changed = True
    while changed:
        changed = False
        before = replace(ret, alts=list(ret.alts))
        seqs = [ret.ref] + list(ret.alts)
        if all(seqs):
            if all(s[-1] == seqs[0][-1] for s in seqs[1:]):
                seqs = [s[:-1] for s in seqs]
                changed = True
                ret.ref = seqs[0]
                ret.alts = seqs[1:]
        if any(not s for s in [ret.ref] + list(ret.alts)):
            used_right_extend = False
            changed = _prepend_ref_base(ret, ref_gaps, cons_gaps, pm, pn, ambig_ref)
            if not changed:
                changed = _append_ref_base(ret, ref_gaps, cons_gaps, pm, pn, ambig_ref)
                used_right_extend = True
            if not changed:
                ret = before
                break
            if used_right_extend:
                break

    _trim_start(ret, False)
    return ret


def _construct_variant(
    draft, contig, pm, pn, ref_gaps, cons_gaps, rstart, rend, is_var,
    ambig_ref, normalize, probs3,
):
    """variant_calling.cpp construct_variant (:218-316)."""
    var_ref = _remove_gaps(ref_gaps[rstart:rend])
    var_preds = [_remove_gaps(s[rstart:rend]) for s in cons_gaps]

    if is_var and all(p == var_ref for p in var_preds):
        return None
    if not ambig_ref and any(c not in _SYMBOL_SET for c in var_ref):
        return None

    var = Variant(
        contig=contig,
        pos=int(pm[rstart]),
        ref=var_ref,
        alts=var_preds,
        filter="PASS",
        genotype=[("GT", "1"), ("GQ", "0")],
        rstart=rstart,
        rend=rend,
    )

    # Variant starts on an insert column: prepend the previous major base.
    if pn[var.rstart] != 0:
        while var.rstart > 0 and pn[var.rstart] != 0:
            var.rstart -= 1
        var.pos = int(pm[var.rstart])
        base = draft[var.pos]
        var.ref = base + var.ref
        var.alts = [base + a for a in var.alts]

    if normalize:
        var = _normalize_variant(ref_gaps, cons_gaps, pm, pn, var, ambig_ref)
        if var is None:
            return None

    if not var.alts or any(not a for a in var.alts):
        var.alts = ["."]

    var.qual = round(
        _compute_consensus_quality(probs3, cons_gaps, var.rstart, var.rend), 3
    )
    return var


def _merge_sorted_variants(
    variants, merge_overlapping, merge_adjacent, draft, contig, pm, pn,
    ref_gaps, cons_gaps, ambig_ref, normalize, probs3,
):
    """variant_calling.cpp merge_sorted_variants (:317-407)."""
    if not (merge_overlapping or merge_adjacent) or not variants:
        return variants
    filtered = []
    furthest_rend = variants[0].rend
    prev_i = 0
    for i in range(1, len(variants)):
        v1, v2 = variants[prev_i], variants[i]
        is_overlapping = v2.rstart < furthest_rend and v2.rend >= v1.rstart
        is_adjacent = v2.rstart == furthest_rend
        if (merge_overlapping and is_overlapping) or (merge_adjacent and is_adjacent):
            furthest_rend = v2.rend
            continue
        new_var = _construct_variant(
            draft, contig, pm, pn, ref_gaps, cons_gaps, v1.rstart, furthest_rend,
            True, ambig_ref, normalize, probs3,
        )
        if new_var is not None and new_var.is_valid:
            filtered.append(new_var)
        furthest_rend = v2.rend
        prev_i = i
    new_var = _construct_variant(
        draft, contig, pm, pn, ref_gaps, cons_gaps, variants[prev_i].rstart,
        furthest_rend, True, ambig_ref, normalize, probs3,
    )
    if new_var is not None and new_var.is_valid:
        filtered.append(new_var)
    return filtered


def normalize_genotype(var: Variant, ploidy: int, min_qual: float) -> Variant:
    """variant_calling.cpp normalize_genotype (:620-681): dedup + sort
    alts, GT from sorted allele indices ('/' separated), GQ = round(qual),
    LowQual filter below min_qual; gVCF records get GT '0'."""
    ret = replace(var, alts=list(var.alts), genotype=list(var.genotype))
    if len(var.alts) > ploidy:
        ret.alts = []
        return ret
    gq = int(round(var.qual))
    if not var.alts or var.filter == "." or var.alts == ["."]:
        ret.alts = ["."]
        ret.genotype = [("GT", "0"), ("GQ", str(gq))]
        ret.filter = "."
        return ret
    unique_alts = sorted({a for a in var.alts if a != var.ref})
    alt_ids = {a: i + 1 for i, a in enumerate(unique_alts)}
    alt_ids[var.ref] = 0
    alleles = sorted(alt_ids.get(a, 0) for a in var.alts)
    ret.alts = unique_alts
    ret.genotype = [
        ("GT", "/".join(str(a) for a in alleles)),
        ("GQ", str(gq)),
    ]
    ret.filter = "PASS" if var.qual >= min_qual else "LowQual"
    return ret


def decode_variants(
    draft: str,
    contig: str,
    probs: np.ndarray,  # [P, C] haploid or [P, H, C] polyploid probabilities
    positions_major: np.ndarray,
    positions_minor: np.ndarray,
    *,
    min_qual: float = 3.0,
    ambig_ref: bool = False,
    return_all: bool = False,
    normalize: bool = True,
    merge_overlapping: bool = True,
    merge_adjacent: bool = True,
) -> list[Variant]:
    """general_decode_variants (variant_calling.cpp:929-1152). With
    ``return_all`` (gVCF) every major column also yields a reference record
    whose GQ is the phred-scaled model probability of the reference base
    (compute_ref_quality) — per-position records, not fixed-GQ END blocks."""
    probs = np.asarray(probs, dtype=np.float64)
    probs3 = probs[:, None, :] if probs.ndim == 2 else probs
    pm = np.asarray(positions_major)
    pn = np.asarray(positions_minor)
    if len(pm) == 0:
        return []
    num_haps = probs3.shape[1]

    ref_gaps = _extract_draft_with_gaps(draft, pm, pn)
    cons_gaps = [
        "".join(SYMBOLS[c] for c in probs3[:, h, :].argmax(axis=-1))
        for h in range(num_haps)
    ]

    is_variant = _find_variants(pn, ref_gaps, cons_gaps, restrict_symbols=not ambig_ref)

    variants = []
    for rstart, rend, is_var in _run_length_encode(is_variant):
        if not is_var:
            continue
        var = _construct_variant(
            draft, contig, pm, pn, ref_gaps, cons_gaps, rstart, rend, True,
            ambig_ref, normalize, probs3,
        )
        if var is not None and var.is_valid:
            variants.append(var)

    if merge_overlapping or merge_adjacent:
        variants.sort(key=lambda v: v.pos)
        variants = _merge_sorted_variants(
            variants, merge_overlapping, merge_adjacent, draft, contig, pm, pn,
            ref_gaps, cons_gaps, ambig_ref, normalize, probs3,
        )

    if return_all:
        # Per-major-column homozygous-reference records (gVCF), GQ from the
        # model's reference probability (variant_calling.cpp:1090-1112).
        for i in np.flatnonzero(pn == 0):
            i = int(i)
            pos = int(pm[i])
            variants.append(
                Variant(
                    contig=contig,
                    pos=pos,
                    ref=draft[pos],
                    alts=["."],
                    qual=round(_compute_ref_quality(probs3, ref_gaps, i, i + 1), 3),
                    filter=".",
                    genotype=[("GT", "0"), ("GQ", "0")],
                    rstart=i,
                    rend=i + 1,
                )
            )

    variants.sort(key=lambda v: v.pos)
    out = []
    for var in variants:
        new_var = normalize_genotype(var, num_haps, min_qual)
        if new_var.is_valid:
            out.append(new_var)
    return out


def call_variants(
    draft: str,
    contig: str,
    logits: np.ndarray,  # [P, num_classes]
    positions_major: np.ndarray,
    positions_minor: np.ndarray,
    **kwargs,
) -> list[Variant]:
    """Haploid convenience wrapper: softmax the logits and decode."""
    return decode_variants(
        draft, contig, _softmax(np.asarray(logits, dtype=np.float64)),
        positions_major, positions_minor, **kwargs,
    )


def call_variants_diploid(
    draft: str,
    contig: str,
    probs2: np.ndarray,  # [P, 2, num_classes] per-haplotype probabilities
    positions_major: np.ndarray,
    positions_minor: np.ndarray,
    **kwargs,
) -> list[Variant]:
    """Diploid convenience wrapper over two-haplotype model probabilities
    (the SlotAttentionConsensus / VariantPerceiver heads)."""
    return decode_variants(
        draft, contig, np.asarray(probs2, dtype=np.float64),
        positions_major, positions_minor, **kwargs,
    )


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


class VcfWriter:
    """VCFv4.1 text writer (vcf_writer.cpp:40-90 header layout)."""

    def __init__(self, stream: TextIO, contigs: list[tuple[str, int]], gvcf: bool = False):
        self._fh = stream
        self._fh.write("##fileformat=VCFv4.1\n")
        for name, length in contigs:
            self._fh.write(f"##contig=<ID={name},length={length}>\n")
        self._fh.write('##FILTER=<ID=PASS,Description="All filters passed">\n')
        self._fh.write(
            '##FILTER=<ID=LowQual,Description="Low quality variant">\n'
        )
        self._fh.write(
            '##INFO=<ID=DP,Number=1,Type=Integer,Description="Total Depth">\n'
        )
        self._fh.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        self._fh.write(
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">\n'
        )
        self._fh.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n"
        )
        self.records_written = 0

    def write(self, v: Variant) -> None:
        fmt_keys = ":".join(k for k, _ in v.genotype) or "GT"
        fmt_vals = ":".join(val for _, val in v.genotype) or "."
        self._fh.write(
            f"{v.contig}\t{v.pos + 1}\t.\t{v.ref}\t{','.join(v.alts) or '.'}\t"
            f"{v.qual:.1f}\t{v.filter}\t.\t{fmt_keys}\t{fmt_vals}\n"
        )
        self.records_written += 1
