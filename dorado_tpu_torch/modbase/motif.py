"""IUPAC motif matching over basecalled sequences.

Port of ``dorado_tpu/modbase/motif.py`` (parity: dorado/modbase/
MotifMatcher.cpp): overlapping hits are included, because the reference
resumes the search one position past each match's start."""

from __future__ import annotations

import re

IUPAC_CODES = {
    "A": "A",
    "C": "C",
    "G": "G",
    "T": "T",
    "U": "T",
    "R": "[AG]",
    "Y": "[CT]",
    "S": "[GC]",
    "W": "[AT]",
    "K": "[GT]",
    "M": "[AC]",
    "B": "[CGT]",
    "D": "[AGT]",
    "H": "[ACT]",
    "V": "[ACG]",
    "N": "[ACGT]",
}


def expand_motif_regex(motif: str) -> str:
    return "(" + "".join(IUPAC_CODES[b] for b in motif) + ")"


class MotifMatcher:
    def __init__(self, motif: str, offset: int):
        self.motif = motif
        self.offset = offset
        self._re = re.compile(expand_motif_regex(motif))

    def get_motif_hits(self, seq: str) -> list[int]:
        hits = []
        pos = 0
        while True:
            m = self._re.search(seq, pos)
            if m is None:
                break
            hits.append(m.start() + self.offset)
            pos = m.start() + 1
        return hits
