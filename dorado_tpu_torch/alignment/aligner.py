"""Alignment of basecalled records (the role of dorado's AlignerNode): a
record's sequence mapped by the port's mapper, the best hit written into
the record (flag, position, MAPQ, CIGAR, NM, AS and, with a BED file, the
``bh`` hit count), and the lower-ranked hits as secondary records. The JAX
package does this inline in its ``aligner`` command and in the basecaller's
``--reference`` stage (``dorado_tpu/cli/main.py``); the port's ``aligner``
command and ``BasecallerPipeline(aligner=...)`` share this class.
"""

from __future__ import annotations

import re

from dorado_tpu_torch.alignment.bed_file import BedFile
from dorado_tpu_torch.alignment.index import ReferenceIndex
from dorado_tpu_torch.alignment.mapper import Alignment, Mapper
from dorado_tpu_torch.io.sam import SamRecord, SamTag
from dorado_tpu_torch.utils.sequence import reverse_complement

# the tags an alignment writes, dropped from a record before it is aligned
ALIGNMENT_TAGS = ("NM", "AS", "bh")
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


class RecordAligner:
    """Maps records against ``index``, keeping up to ``n_secondary``
    lower-ranked hits as secondary records (minimap2's ``-N``). ``align`` is
    safe to call from several threads: the mapper's banded alignments run in
    C++ without the interpreter lock."""

    def __init__(self, index: ReferenceIndex, bed: BedFile | None = None,
                 n_secondary: int = 0):
        self.index = index
        self.mapper = Mapper(index, max_alignments=1 + n_secondary)
        self.bed = bed

    def align(self, rec: SamRecord) -> list[SamRecord]:
        """Write the best hit of ``rec``'s sequence into ``rec`` (or set its
        unmapped flag, 4) and return the secondary records (0x100, SEQ and
        QUAL omitted as minimap2 emits them) of the other hits."""
        seq = rec.seq if rec.seq != "*" else ""
        alns = self.mapper.map(seq) if seq else []
        if not alns:
            rec.flag |= 4
            return []
        a = alns[0]
        rec.flag = 16 if a.is_reverse else 0
        rec.rname = a.ref_name
        rec.pos = a.ref_start + 1
        rec.mapq = a.mapq
        rec.cigar = a.cigar
        if a.is_reverse:
            rec.seq = reverse_complement(seq)
            if rec.qual != "*":
                rec.qual = rec.qual[::-1]
        rec.tags = [t for t in rec.tags if t.tag not in ALIGNMENT_TAGS]
        rec.tags.append(SamTag("NM", "i", a.nm))
        rec.tags.append(SamTag("AS", "i", a.score))
        if self.bed is not None:
            rec.tags.append(SamTag("bh", "i", self.bed_hits(a)))
        return [
            SamRecord(qname=rec.qname, flag=0x100 | (16 if sec.is_reverse else 0),
                      rname=sec.ref_name, pos=sec.ref_start + 1, mapq=0, cigar=sec.cigar,
                      seq="*", qual="*",
                      tags=[SamTag("NM", "i", sec.nm), SamTag("AS", "i", sec.score)])
            for sec in alns[1:]
        ]

    def bed_hits(self, a: Alignment) -> int:
        """BED intervals over the hit's reference span from its CIGAR
        (AlignerNode.cpp:252-265)."""
        span = sum(int(n) for n, op in _CIGAR_RE.findall(a.cigar) if op in "MDN=X")
        return self.bed.hits(a.ref_name, a.ref_start, a.ref_start + span, a.is_reverse)
