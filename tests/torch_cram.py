"""A small reference-based CRAM for the port's tests (numpy only): mapped
records of a seeded contig written with ``ref_seqs`` (RR=true), which, as in
the JAX package, ``read_records`` cannot read without the contig."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from dorado_tpu_torch.io.cram import CramWriter
from dorado_tpu_torch.io.sam import SamHeader, SamRecord


def rr_cram(path: Path | str, seed: int = 0, n: int = 4) -> dict[str, str]:
    """Write ``n`` reads of 60 bases mapped to a 1 kb contig ``ctg`` as an
    RR=true CRAM at ``path``; returns the reference (name -> bases)."""
    rng = np.random.RandomState(seed)
    contig = "".join(rng.choice(list("ACGT"), 1000))
    header = SamHeader()
    header.references = [("ctg", len(contig))]
    with open(path, "wb") as fh:
        writer = CramWriter(fh, header, ref_seqs={"ctg": contig})
        for i in range(n):
            pos = int(rng.randint(1, 900))
            writer.write(SamRecord(qname=f"r{i}", flag=0, rname="ctg", pos=pos, mapq=60,
                                   cigar="60M", seq=contig[pos - 1:pos + 59], qual="5" * 60))
        writer.close()
    return {"ctg": contig}
