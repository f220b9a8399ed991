"""Reference minimizer index (the role of minimap2's mm_idx for the
from-scratch aligner): sorted hash table of reference minimizers over all
contigs, with high-frequency minimizer masking. Port of
``dorado_tpu/alignment/index.py``, line for line."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from dorado_tpu_torch.alignment.minimizer import minimizers


def read_fasta(path: Path | str) -> list[tuple[str, str]]:
    """[(name, sequence)] from a FASTA file."""
    out = []
    name = None
    parts: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(parts)))
                fields = line[1:].split()
                # tolerate a bare '>' header instead of IndexError
                name = fields[0] if fields else f"unnamed_{len(out)}"
                parts = []
            else:
                parts.append(line.upper())
    if name is not None:
        out.append((name, "".join(parts)))
    return out


@dataclass
class ReferenceIndex:
    names: list[str]
    lengths: list[int]
    seqs: list[str]
    k: int
    w: int
    # sorted minimizer arrays
    hashes: np.ndarray  # u64, sorted
    positions: np.ndarray  # i64 global position
    strands: np.ndarray  # u8
    seq_ids: np.ndarray  # i32
    max_occ: int = 500

    @classmethod
    def build(
        cls, fasta: Path | str | list[tuple[str, str]], k: int = 15, w: int = 10,
        max_occ_frac: float = 2e-4,
    ) -> "ReferenceIndex":
        contigs = read_fasta(fasta) if not isinstance(fasta, list) else fasta
        names = [n for n, _ in contigs]
        seqs = [s for _, s in contigs]
        lengths = [len(s) for s in seqs]

        all_h, all_p, all_s, all_id = [], [], [], []
        for i, s in enumerate(seqs):
            h, p, st = minimizers(s, k, w)
            all_h.append(h)
            all_p.append(p)
            all_s.append(st)
            all_id.append(np.full(len(h), i, dtype=np.int32))
        hashes = np.concatenate(all_h) if all_h else np.zeros(0, np.uint64)
        positions = np.concatenate(all_p) if all_p else np.zeros(0, np.int64)
        strands = np.concatenate(all_s) if all_s else np.zeros(0, np.uint8)
        seq_ids = np.concatenate(all_id) if all_id else np.zeros(0, np.int32)

        order = np.argsort(hashes, kind="stable")
        hashes = hashes[order]
        positions = positions[order]
        strands = strands[order]
        seq_ids = seq_ids[order]

        # mask minimizers occurring too often (repeats)
        if len(hashes):
            _, counts = np.unique(hashes, return_counts=True)
            max_occ = max(10, int(np.quantile(counts, 1.0 - max_occ_frac))) if len(counts) else 10
        else:
            max_occ = 10

        return cls(
            names=names,
            lengths=lengths,
            seqs=seqs,
            k=k,
            w=w,
            hashes=hashes,
            positions=positions,
            strands=strands,
            seq_ids=seq_ids,
            max_occ=max_occ,
        )

    def lookup(self, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """For query hashes h: (start, end) ranges into the sorted arrays."""
        lo = np.searchsorted(self.hashes, h, side="left")
        hi = np.searchsorted(self.hashes, h, side="right")
        return lo, hi
