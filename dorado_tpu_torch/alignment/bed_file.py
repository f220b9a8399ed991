"""BED file parsing and alignment intersection (port of
``dorado_tpu/alignment/bed_file.py``).


Reproduces alignment/bed_file.cpp:15-255 (3-12 tab-separated columns,
browser/track header lines, '#'/blank comments, consistent column counts,
optional strand in column 6) and AlignerNode::add_bed_hits_to_record
(AlignerNode.cpp:252-265): the `bh:i` tag counts BED intervals overlapping
the alignment span on a matching (or '.') strand.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class BedEntry:
    start: int
    end: int
    strand: str = "."
    bed_line: str = ""


class BedFileError(ValueError):
    pass


@dataclass
class BedFile:
    entries: dict[str, list[BedEntry]] = field(default_factory=dict)

    @classmethod
    def load(cls, filename: str | Path) -> "BedFile":
        bed = cls()
        columns_per_entry = 0
        in_header = True
        for lineno, line in enumerate(Path(filename).read_text().splitlines(), 1):
            stripped = line.rstrip()
            if not stripped or stripped[0] == "#":
                continue
            if in_header and (
                stripped.startswith("browser") or stripped.startswith("track")
            ):
                continue
            in_header = False
            tokens = line.split("\t")
            if columns_per_entry == 0:
                columns_per_entry = len(tokens)
            elif len(tokens) != columns_per_entry:
                raise BedFileError(
                    f"Invalid BED line {lineno}: inconsistent number of columns. "
                    f"Expected: {columns_per_entry} actual: {len(tokens)}."
                )
            if len(tokens) < 3:
                raise BedFileError(f"Invalid BED line {lineno}: too few columns (minimum 3).")
            if len(tokens) > 12:
                raise BedFileError(f"Invalid BED line {lineno}: too many columns (maximum 12).")
            genome = tokens[0]
            if not genome:
                raise BedFileError(f"Invalid BED line {lineno}: missing [CHROM].")
            try:
                start, end = int(tokens[1]), int(tokens[2])
            except ValueError as e:
                raise BedFileError(f"Invalid BED line {lineno}: bad START/END.") from e
            strand = "."
            if len(tokens) > 5:
                if tokens[5] not in ("+", "-", "."):
                    raise BedFileError(f"Invalid BED line {lineno}: bad [STRAND].")
                strand = tokens[5]
            bed.entries.setdefault(genome, []).append(
                BedEntry(start=start, end=end, strand=strand, bed_line=stripped)
            )
        return bed

    def hits(self, genome: str, genome_start: int, genome_end: int, is_reverse: bool) -> int:
        """Number of intervals overlapping [genome_start, genome_end) on the
        matching strand (AlignerNode.cpp:252-265)."""
        direction = "-" if is_reverse else "+"
        count = 0
        for e in self.entries.get(genome, []):
            if not (e.start >= genome_end or e.end <= genome_start) and (
                e.strand == direction or e.strand == "."
            ):
                count += 1
        return count
