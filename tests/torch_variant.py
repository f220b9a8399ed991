"""Seeded diploid inputs for variant calling: a draft, two haplotypes that
differ from it by seeded homozygous and heterozygous SNPs and short indels,
and reads of both haplotypes from both strands (numpy only;
``chip_smoke.py`` uses them too); the parity tests' files
(``variant_files``: FASTA, FASTQ, a SAM with HP tags through the port's
mapper, and a candidates file)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from tests.torch_polish import mutate, revcomp, write_fasta, write_fastq

_BASES = "ACGT"


def _apply(rng: np.random.RandomState, seq: list[str], pos: int, kind: int) -> None:
    """A SNP (0), an insertion of 1-3 bases after ``pos`` (1) or a deletion
    of 1-3 bases from ``pos`` (2), in place."""
    if kind == 0:
        seq[pos] = rng.choice([b for b in _BASES if b != seq[pos]])
    elif kind == 1:
        seq[pos] = seq[pos] + "".join(rng.choice(list(_BASES), rng.randint(1, 4)))
    else:
        for i in range(pos, min(len(seq), pos + rng.randint(1, 4))):
            seq[i] = ""


def diploid_inputs(seed: int, draft_len: int, n_reads: int, read_len: tuple[int, int],
                   error: float = 0.08, hom_rate: float = 0.002, het_rate: float = 0.004,
                   gap: tuple[int, int] | None = None):
    """(draft, (hap1, hap2), sites, reads): a random draft of ``draft_len``
    bases; each haplotype is the draft with the homozygous sites (at
    ``hom_rate`` of positions, both haplotypes) and its own heterozygous
    sites (``het_rate``, split between them) applied, each a SNP, a short
    insertion or a short deletion (``sites``: (draft position, kind, "hom"
    or 1 or 2), 30 bases apart at least); ``n_reads`` reads of ``read_len``
    (low, high) bases at ``error``, alternately of each haplotype, on a
    random strand: (name, sequence, phred qualities 5-30 as a string,
    haplotype 1 or 2). With ``gap`` (lo, hi) no read covers those draft
    positions (columns without reads)."""
    rng = np.random.RandomState(seed)
    draft = "".join(rng.choice(list(_BASES), draft_len))
    haps = [list(draft), list(draft)]
    sites = []
    pos = 30
    while pos < draft_len - 30:
        u = rng.rand()
        if u < hom_rate + het_rate:
            kind = int(rng.randint(0, 3))
            which = "hom" if u < hom_rate else int(rng.randint(1, 3))
            for h in ((0, 1) if which == "hom" else (which - 1,)):
                _apply(np.random.RandomState(seed * 7919 + pos), haps[h], pos, kind)
            sites.append((pos, kind, which))
            pos += 30
        else:
            pos += 1
    # each haplotype's draft coordinate at its every base, to place the gap
    coords = [np.concatenate([np.full(len(s), i) for i, s in enumerate(h)]) for h in haps]
    haps = ["".join(h) for h in haps]
    reads = []
    for i in range(n_reads):
        h = i % 2
        n = rng.randint(*read_len)
        while True:
            start = rng.randint(0, max(1, len(haps[h]) - n // 2))
            stop = min(len(haps[h]), start + n)
            lo, hi = coords[h][start], coords[h][stop - 1]
            if gap is None or hi < gap[0] or lo >= gap[1]:
                break
        seq = mutate(rng, haps[h][start:stop], error)
        if rng.rand() < 0.5:
            seq = revcomp(seq)
        qual = (rng.randint(5, 31, len(seq)) + 33).astype(np.uint8).tobytes().decode()
        reads.append((f"read_{i}", seq, qual, h + 1))
    return draft, tuple(haps), sites, reads


def variant_files(d: Path, seed: int = 41, draft_len: int = 1000, n_reads: int = 24,
                  read_len: tuple[int, int] = (250, 700), gap: tuple[int, int] = (700, 712)):
    """One draft contig and two-haplotype reads of it, with a coverage gap:
    {"fasta", "fastq", "sam" (the port's mapper's alignments, each with its
    haplotype as an HP tag), "candidates" (every site and two positions
    without one, contig and position a line), "sites", "dir"}."""
    from dorado_tpu_torch.alignment import Mapper, ReferenceIndex
    from dorado_tpu_torch.io.sam import SamHeader, SamRecord, SamTag, SamWriter

    draft, _, sites, reads = diploid_inputs(seed, draft_len, n_reads, read_len, gap=gap)
    drafts = [("ctg", draft)]
    out = {"dir": d, "sites": sites, "fasta": write_fasta(d / "draft.fa", drafts),
           "fastq": write_fastq(d / "reads.fastq", [r[:3] for r in reads])}
    mapper = Mapper(ReferenceIndex.build(drafts))
    records = []
    for name, seq, qual, hap in reads:
        for a in mapper.map(seq):
            records.append(SamRecord(
                qname=name, flag=16 if a.is_reverse else 0, rname=a.ref_name,
                pos=a.ref_start + 1, mapq=a.mapq, cigar=a.cigar,
                seq=revcomp(seq) if a.is_reverse else seq,
                qual=qual[::-1] if a.is_reverse else qual,
                tags=[SamTag("NM", "i", a.nm), SamTag("HP", "i", hap)]))
    records.sort(key=lambda r: r.pos)
    out["sam"] = d / "reads.sam"
    with open(out["sam"], "w") as fh:
        w = SamWriter(fh, SamHeader(references=[(n, len(s)) for n, s in drafts]))
        for rec in records:
            w.write(rec)
    out["candidates"] = d / "candidates.tsv"
    positions = sorted({p for p, _, _ in sites} | {150, draft_len - 200})
    out["candidates"].write_text("".join(f"ctg\t{p}\n" for p in positions))
    return out
