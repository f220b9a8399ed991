"""sequencing_summary.txt generation (port of ``dorado_tpu/io/summary.py``)
(parity: dorado/hts_writer/SummaryFileWriter.cpp and dorado/cli/cli_lib/
summary.cpp — the ``dorado summary`` subcommand over a basecalled BAM/SAM).
"""

from __future__ import annotations

from typing import TextIO

from dorado_tpu_torch.io.sam import SamRecord

GENERAL_FIELDS = [
    "input_filename",
    "batch_id",
    "parent_read_id",
    "read_id",
    "run_id",
    "channel",
    "mux",
    "minknow_events",
    "start_time",
    "duration",
]
BASECALLING_FIELDS = [
    "passes_filtering",
    "template_start",
    "num_events_template",
    "template_duration",
    "sequence_length_template",
    "mean_qscore_template",
]
EXPERIMENT_FIELDS = ["pore_type", "experiment_id", "sample_id", "end_reason"]
BARCODING_FIELDS = ["alias", "type", "barcode_arrangement", "barcode_kit", "barcode_variant"]
ALIGNMENT_FIELDS = [
    "alignment_genome",
    "alignment_direction",
    "alignment_genome_start",
    "alignment_genome_end",
    "alignment_strand_start",
    "alignment_strand_end",
    "alignment_num_insertions",
    "alignment_num_deletions",
    "alignment_num_aligned",
    "alignment_num_correct",
    "alignment_identity",
    "alignment_accuracy",
    "alignment_score",
    "alignment_coverage",
    "alignment_bed_hits",
    "alignment_mapping_quality",
]


def _cigar_stats(cigar: str):
    import re

    ins = dele = aligned = lead_clip = tail_clip = 0
    ops = re.findall(r"(\d+)([MIDNSHP=X])", cigar)
    for i, (n, op) in enumerate(ops):
        n = int(n)
        if op == "I":
            ins += n
        elif op in "DN":
            dele += n
        elif op in "M=X":
            aligned += n
        elif op == "S":
            if aligned == 0 and ins == 0:
                lead_clip += n
            else:
                tail_clip += n
    return ins, dele, aligned, lead_clip, tail_clip


def _tag(rec: SamRecord, name: str, default):
    for t in rec.tags:
        if t.tag == name:
            return t.value
    return default


def _parse_rg_run_ids(header_text: str) -> dict[str, str]:
    """RG id -> runid (from the DS field of @RG header lines)."""
    out = {}
    for line in header_text.splitlines():
        if not line.startswith("@RG"):
            continue
        rg_id = None
        run_id = ""
        for fieldv in line.split("\t")[1:]:
            key, _, value = fieldv.partition(":")
            if key == "ID":
                rg_id = value
            elif key == "DS":
                for part in value.split():
                    if part.startswith("runid="):
                        run_id = part[len("runid=") :]
        if rg_id:
            out[rg_id] = run_id
    return out


def summary_row(
    rec: SamRecord,
    has_barcodes: bool,
    has_alignment: bool,
    rg_runs: dict[str, str],
    model_stride: int = 0,
) -> str | None:
    """One summary TSV line for a record; None for secondary/supplementary."""
    if rec.flag & 0x900:  # secondary/supplementary
        return None
    duration = float(_tag(rec, "du", 0.0))
    ns = int(_tag(rec, "ns", 0))
    ts = int(_tag(rec, "ts", 0))
    sample_rate = ns / duration if duration > 0 else 0.0
    rg = _tag(rec, "RG", "")
    run_id = rg_runs.get(rg, rg.rsplit("_", 1)[0] if rg else "unknown")

    start_time = 0.0  # without read attrs, relative start is unknown
    template_start = start_time + (ts / sample_rate if sample_rate else 0.0)
    template_samples = ns - ts
    template_duration = template_samples / sample_rate if sample_rate else 0.0
    stride = model_stride
    if not stride:
        mv = _tag(rec, "mv", None)
        if mv is not None and len(mv):
            stride = int(mv[0])
    events = template_samples // stride if stride else 0
    seq_len = len(rec.seq) if rec.seq != "*" else 0

    vals = [
        _tag(rec, "fn", "unknown"),
        "0",
        _tag(rec, "pi", rec.qname),
        rec.qname,
        run_id,
        int(_tag(rec, "ch", 0)),
        int(_tag(rec, "mx", 0)),
        int(_tag(rec, "me", 0)),
        f"{start_time:.6f}",
        f"{duration:.6f}",
        "TRUE",
        f"{template_start:.6f}",
        events,
        f"{template_duration:.6f}",
        seq_len,
        f"{float(_tag(rec, 'qs', 0.0)):.6f}",
        _tag(rec, "po", "not_set"),
        "unknown",
        "unknown",
        _tag(rec, "er", "unknown"),
    ]
    if has_barcodes:
        bc = _tag(rec, "BC", "unclassified")
        vals += [bc, "unknown", bc, _tag(rec, "bk", "unknown"),
                 _tag(rec, "bv", "n/a")]
    if has_alignment:
        mapped = not (rec.flag & 4) and rec.rname not in ("", "*")
        if mapped and rec.cigar != "*":
            ins, dele, aligned, lead, tail = _cigar_stats(rec.cigar)
            nm = int(_tag(rec, "NM", 0))
            mismatches = max(nm - ins - dele, 0)
            correct = aligned - mismatches
            identity = correct / aligned if aligned else 0.0
            accuracy = correct / (aligned + ins + dele) if aligned else 0.0
            strand_start = lead
            strand_end = seq_len - tail
            coverage = (strand_end - strand_start) / seq_len if seq_len else 0.0
            vals += [
                rec.rname,
                "-" if rec.flag & 16 else "+",
                rec.pos - 1,
                rec.pos - 1 + aligned + dele,
                strand_start,
                strand_end,
                ins,
                dele,
                aligned,
                correct,
                f"{identity:.6f}",
                f"{accuracy:.6f}",
                int(_tag(rec, "AS", 0)),
                f"{coverage:.6f}",
                int(_tag(rec, "bh", 0)),
                rec.mapq,
            ]
        else:
            vals += ["*", "-1", -1, -1, -1, -1, 0, 0, 0, 0,
                     "0.000000", "0.000000", 0, "0.000000", 0, 0]
    return "\t".join(str(v) for v in vals)


def summary_columns(has_barcodes: bool, has_alignment: bool) -> list[str]:
    columns = GENERAL_FIELDS + BASECALLING_FIELDS + EXPERIMENT_FIELDS
    if has_barcodes:
        columns = columns + BARCODING_FIELDS
    if has_alignment:
        columns = columns + ALIGNMENT_FIELDS
    return columns


class StreamingSummaryWriter:
    """Per-record summary TSV writer for basecaller --emit-summary
    (basecall_output_args.cpp:35-37, SummaryFileWriter streaming): column
    groups are chosen UP FRONT from the run configuration (the reference's
    FieldFlags), not sniffed from the records."""

    def __init__(self, out: TextIO, has_barcodes: bool, has_alignment: bool,
                 rg_runs: dict[str, str] | None = None, model_stride: int = 0):
        self._out = out
        self._hb = has_barcodes
        self._ha = has_alignment
        self._rg_runs = rg_runs or {}
        self._stride = model_stride
        self.rows = 0
        out.write("\t".join(summary_columns(has_barcodes, has_alignment)) + "\n")

    def write(self, rec: SamRecord) -> None:
        line = summary_row(rec, self._hb, self._ha, self._rg_runs, self._stride)
        if line is not None:
            self._out.write(line + "\n")
            self.rows += 1


def write_summary(
    records: list[SamRecord],
    out: TextIO,
    header_text: str = "",
    model_stride: int = 0,
) -> int:
    """Write the summary TSV; returns the number of rows."""
    rg_runs = _parse_rg_run_ids(header_text)
    # optional column groups appear when any record carries the data
    # (SummaryFileWriter.cpp:46-85)
    has_barcodes = any(_tag(r, "BC", None) is not None for r in records)
    has_alignment = any(
        not (r.flag & 4) and r.rname not in ("", "*") for r in records
    )
    out.write("\t".join(summary_columns(has_barcodes, has_alignment)) + "\n")
    rows = 0
    for rec in records:
        line = summary_row(rec, has_barcodes, has_alignment, rg_runs, model_stride)
        if line is not None:
            out.write(line + "\n")
            rows += 1
    return rows
