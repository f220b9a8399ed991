"""Adapter & primer detection.

Port of ``dorado_tpu/demux/adapters.py``: parity with
dorado/demux/AdapterDetector.cpp and the sequence tables in
dorado/demux/adapter_primer_kits.cpp:29-110 (transcribed — release metadata).
Adapters are searched in the first/last 75 bp, primers in the first/last
150 bp, via infix alignment with N-wildcards; score = 1 - dist/len with a
0.8 acceptance threshold at trim time. Custom primers (``--primer-sequences``)
are an argument of the finders (``custom_primers``), not a process-wide
registry as in the JAX package. ``ReadTrimmer`` is the basecaller's
``--trim`` and the ``trim`` command: adapters, then primers, cut from a
record.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dorado_tpu_torch.demux.trimmer import trim_record
from dorado_tpu_torch.io.sam import SamRecord
from dorado_tpu_torch.utils.align import MODE_HW, align, make_equality_table
from dorado_tpu_torch.utils.sequence import reverse_complement

ADAPTER_TRIM_LENGTH = 75
PRIMER_TRIM_LENGTH = 150
TRIM_SCORE_THRESHOLD = 0.8

# adapter_primer_kits.cpp:29-31
ADAPTERS = {
    "LSK110": ("CCTGTACTTCGTTCAGTTACGTATTGC", "AGCAATACGTAACTGAAC"),
    "RNA004": ("", "GGTTGTTTCTGTTGGTGCTG"),
}

# adapter_primer_kits.cpp:52-84 (front = SSP, rear = VNP)
PRIMERS = {
    "cDNA": ("TTTCTGTTGGTGCTGATATTGCTGGG", "ACTTGCCTGTCGCTCTATCTTCTTT"),
    "PCS110": (
        "TTTCTGTTGGTGCTGATATTGCTTT",
        "ACTTGCCTGTCGCTCTATCTTCAGAGGAGAGTCCGCCGCCCGCAAGTTTT",
    ),
    "RAD": ("GTTTTCGCATTTATCGTGAAACGCTTTCGCGTTTTTCGTGCGCCGCTTCA", ""),
    "10X_Genomics": ("CTACACGACGCTCTTCCGATCT", "GTACTCTGCGTTGATACCACTGCTT"),
}

# kit name -> adapter codes (adapter_primer_kits.cpp:36-47); keys hold kit
# name prefixes after stripping the -260 suffix
_LSK110_KITS = {
    "SQK-LSK114", "SQK-LSK114-XL", "SQK-PCS114", "SQK-RAD114", "SQK-ULK114",
    "SQK-16S114-24", "SQK-MAB114-24", "SQK-MLK114-96-XL", "SQK-NBD114-24",
    "SQK-NBD114-96", "SQK-PCB114-24", "SQK-RBK114-24", "SQK-RBK114-96",
    "SQK-RPB114-24", "SQK-HTB114-96",
}
_RNA004_KITS = {"SQK-RNA004", "SQK-RNA004-XL", "SQK-DRB004-24"}

_PRIMER_KITS = {
    "cDNA": {"SQK-LSK114", "SQK-LSK114-XL"},
    "PCS110": {"SQK-PCS114", "SQK-PCB114-24"},
    "RAD": {"SQK-RAD114", "SQK-ULK114", "SQK-RBK114-24", "SQK-RBK114-96"},
    "10X_Genomics": {"SQK-LSK114", "SQK-LSK114-XL"},
}

_EQ = make_equality_table([("N", "A"), ("N", "T"), ("N", "C"), ("N", "G")])


def _norm_kit(kit_name: str) -> str:
    return kit_name.removesuffix("-260")


def adapters_for_kit(kit_name: str | None) -> list[tuple[str, str, str]]:
    """(name, front, rear) adapters to search for this kit (all if None)."""
    if kit_name is None:
        return [(n, f, r) for n, (f, r) in ADAPTERS.items()]
    kit = _norm_kit(kit_name)
    out = []
    if kit in _LSK110_KITS:
        f, r = ADAPTERS["LSK110"]
        out.append(("LSK110", f, r))
    if kit in _RNA004_KITS:
        f, r = ADAPTERS["RNA004"]
        out.append(("RNA004", f, r))
    return out


def primers_for_kit(
    kit_name: str | None, custom_primers: dict[str, str] | None = None
) -> list[tuple[str, str, str]]:
    """FWD/REV primer query pairs (AdapterDetector.cpp:185-208); with
    ``custom_primers`` (a --primer-sequences FASTA, parse_custom_sequences.cpp)
    those alone, each searched at the front and, reverse-complemented, at
    the rear."""
    if custom_primers:
        return [(n, seq, reverse_complement(seq)) for n, seq in custom_primers.items()]
    names = (
        list(PRIMERS)
        if kit_name is None
        else [n for n, kits in _PRIMER_KITS.items() if _norm_kit(kit_name) in kits]
    )
    out = []
    for n in names:
        front, rear = PRIMERS[n]
        out.append((f"{n}_FWD", front, reverse_complement(rear) if rear else ""))
        out.append((f"{n}_REV", rear, reverse_complement(front) if front else ""))
    return out


@dataclass
class SingleEndResult:
    name: str = "unclassified"
    score: float = -1.0
    position: tuple[int, int] = (-1, -1)


@dataclass
class AdapterScoreResult:
    front: SingleEndResult = field(default_factory=SingleEndResult)
    rear: SingleEndResult = field(default_factory=SingleEndResult)


def _align_query(query: str, window: str, offset: int) -> SingleEndResult:
    if not query or not window:
        return SingleEndResult()
    res = align(query, window, mode=MODE_HW, equalities=_EQ)
    score = 1.0 - res.distance / len(query)
    return SingleEndResult(
        score=score, position=(offset + res.t_start, offset + res.t_end - 1)
    )


def _best(results: list[SingleEndResult]) -> SingleEndResult:
    """Highest score; near-ties (within 0.1) pick the longer span
    (AdapterDetector.cpp get_best_result)."""
    best = None
    best_score = -1.0
    eps = 0.1
    for r in results:
        old_span = 0 if best is None else best.position[1] - best.position[0]
        new_span = r.position[1] - r.position[0]
        if r.score > best_score + eps:
            best_score = r.score
            best = r
        if best is not None and abs(r.score - best_score) <= eps and new_span > old_span:
            best_score = r.score
            best = r
    return best if best is not None else SingleEndResult()


def _detect(seq: str, queries: list[tuple[str, str, str]], trim_len: int) -> AdapterScoreResult:
    front_win = seq[:trim_len]
    rear_start = max(0, len(seq) - trim_len)
    rear_win = seq[rear_start:]

    front_results, rear_results = [], []
    for name, front, rear in queries:
        if front:
            r = _align_query(front, front_win, 0)
            r.name = f"{name}_FRONT"
            front_results.append(r)
        if rear:
            r = _align_query(rear, rear_win, rear_start)
            r.name = f"{name}_REAR"
            rear_results.append(r)
    return AdapterScoreResult(front=_best(front_results), rear=_best(rear_results))


def find_adapters(seq: str, kit_name: str | None = None) -> AdapterScoreResult:
    return _detect(seq, adapters_for_kit(kit_name), ADAPTER_TRIM_LENGTH)


def find_primers(
    seq: str, kit_name: str | None = None, custom_primers: dict[str, str] | None = None
) -> AdapterScoreResult:
    return _detect(seq, primers_for_kit(kit_name, custom_primers), PRIMER_TRIM_LENGTH)


def determine_trim_interval(res: AdapterScoreResult, seqlen: int) -> tuple[int, int]:
    """Retained [start, end) interval (Trimmer.cpp:92-125)."""
    interval = [0, seqlen]
    if res.front.name == "unclassified" or res.front.score < TRIM_SCORE_THRESHOLD:
        res.front.name = "unclassified"
    else:
        interval[0] = res.front.position[1] + 1
    if res.rear.name == "unclassified" or res.rear.score < TRIM_SCORE_THRESHOLD:
        res.rear.name = "unclassified"
    else:
        interval[1] = res.rear.position[0]
    if interval[1] <= interval[0]:
        interval = [0, seqlen]
        res.front.name = "unclassified"
        res.rear.name = "unclassified"
    return interval[0], interval[1]


@dataclass
class ReadTrimmer:
    """Adapters, then primers, found in a record's sequence and cut from it
    with its qualities, move table and modbase tags (TrimmerNode: the JAX
    command's trimming of basecalls, and its ``trim`` command)."""

    adapters: bool = True
    primers: bool = True
    kit_name: str | None = None
    custom_primers: dict[str, str] | None = None

    def trim(self, rec: SamRecord) -> SamRecord:
        """``rec``, trimmed in place."""
        if self.adapters and rec.seq not in ("", "*"):
            res = find_adapters(rec.seq, self.kit_name)
            trim_record(rec, determine_trim_interval(res, len(rec.seq)))
        if self.primers and rec.seq not in ("", "*"):
            res = find_primers(rec.seq, self.kit_name, self.custom_primers)
            trim_record(rec, determine_trim_interval(res, len(rec.seq)))
        return rec
