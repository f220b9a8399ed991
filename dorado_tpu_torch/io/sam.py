"""SAM/BAM record model, header construction and writers.

Record/tag semantics track the reference's unaligned-BAM output
(dorado/read_pipeline/base/messages.cpp:43-130 generate_read_tags;
dorado/hts_utils header handling): per-read tags qs/du/ns/ts/mx/ch/st/rn/fn/
sm/sd/sv/dx, RG, optional mv (move table, stride-first), pi/sp (split reads),
MM/ML/MN (modified bases), pt (poly-A).

BAM encoding is a from-scratch binary serialiser over the BGZF writer; SAM and
FASTQ writers share the same record model.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, TextIO

import numpy as np

from dorado_tpu_torch.io.bgzf import BgzfWriter

_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
# vectorised byte -> nibble map (unknown bases -> N = 15)
_SEQ_NIBBLE_LUT = np.full(256, 15, np.uint8)
for _c, _i in _SEQ_NIBBLE.items():
    _SEQ_NIBBLE_LUT[ord(_c)] = _i
    _SEQ_NIBBLE_LUT[ord(_c.lower())] = _i


@dataclass
class SamTag:
    tag: str
    type: str  # A c C s S i I f Z H B
    value: object
    subtype: str = ""  # for B arrays


@dataclass
class SamRecord:
    qname: str
    flag: int = 4  # unmapped
    rname: str = "*"
    pos: int = 0  # 1-based in SAM; 0 = unmapped
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: list[SamTag] = field(default_factory=list)

    def tag_string(self, t: SamTag) -> str:
        if t.type == "B":
            # an empty array is the subtype alone (no trailing comma)
            return f"{t.tag}:B:{t.subtype}" + "".join(f",{int(v)}" for v in t.value)
        if t.type in "cCsSiI":
            return f"{t.tag}:i:{int(t.value)}"
        if t.type == "f":
            v = float(t.value)
            return f"{t.tag}:f:{v:g}"
        if t.type == "A":
            return f"{t.tag}:A:{t.value}"
        return f"{t.tag}:{t.type}:{t.value}"

    def to_sam_line(self) -> str:
        fields = [
            self.qname,
            str(self.flag),
            self.rname,
            str(self.pos),
            str(self.mapq),
            self.cigar,
            self.rnext,
            str(self.pnext),
            str(self.tlen),
            self.seq,
            self.qual,
        ]
        fields.extend(self.tag_string(t) for t in self.tags)
        return "\t".join(fields)


def _encode_aux(tags: list[SamTag]) -> bytes:
    out = bytearray()
    for t in tags:
        tag_b = t.tag.encode()
        if t.type == "Z":
            out += tag_b + b"Z" + str(t.value).encode() + b"\x00"
        elif t.type == "A":
            out += tag_b + b"A" + str(t.value)[:1].encode()
        elif t.type == "f":
            out += tag_b + b"f" + struct.pack("<f", float(t.value))
        elif t.type in "cCsSiI":
            fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}[t.type]
            out += tag_b + t.type.encode() + struct.pack(fmt, int(t.value))
        elif t.type == "B":
            sub = t.subtype
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            arr = np.asarray(t.value)
            out += tag_b + b"B" + sub.encode() + struct.pack("<I", len(arr))
            out += struct.pack(f"<{len(arr)}{fmt}", *[v for v in arr.tolist()])
        else:
            raise ValueError(f"unsupported tag type {t.type}")
    return bytes(out)


def encode_bam_record(rec: SamRecord, ref_ids: dict[str, int] | None = None) -> bytes:
    """Serialise one alignment record to BAM binary layout."""
    ref_ids = ref_ids or {}
    refid = ref_ids.get(rec.rname, -1)
    pos = rec.pos - 1  # BAM is 0-based
    name = rec.qname.encode() + b"\x00"
    seq = rec.seq if rec.seq != "*" else ""
    l_seq = len(seq)

    # cigar
    cigar_ops = []
    if rec.cigar != "*":
        num = ""
        for ch in rec.cigar:
            if ch.isdigit():
                num += ch
            else:
                op = "MIDNSHP=X".index(ch)
                cigar_ops.append((int(num) << 4) | op)
                num = ""
    n_cigar = len(cigar_ops)

    # 4-bit packed sequence (vectorised: the per-base python loop was the
    # hot spot of BAM writing at realistic base rates)
    nibs = _SEQ_NIBBLE_LUT[np.frombuffer(seq.encode(), np.uint8)]
    if l_seq % 2:
        nibs = np.concatenate([nibs, np.zeros(1, np.uint8)])
    packed = ((nibs[0::2] << 4) | nibs[1::2]).tobytes()
    if rec.qual != "*" and rec.qual:
        qual = (
            np.minimum(
                np.frombuffer(rec.qual.encode(), np.uint8).astype(np.int16) - 33,
                93,
            )
            .astype(np.uint8)
            .tobytes()
        )
    else:
        qual = b"\xff" * l_seq

    # reg2bin for unmapped = 4680
    bin_ = 4680 if pos < 0 else _reg2bin(pos, pos + max(1, l_seq))

    aux = _encode_aux(rec.tags)
    body = struct.pack(
        "<iiBBHHHiiii",
        refid,
        pos,
        len(name),
        rec.mapq,
        bin_,
        n_cigar,
        rec.flag,
        l_seq,
        ref_ids.get(rec.rnext, -1) if rec.rnext != "=" else refid,
        rec.pnext - 1,
        rec.tlen,
    )
    body += name
    body += struct.pack(f"<{n_cigar}I", *cigar_ops)
    body += bytes(packed)
    body += qual
    body += aux
    return struct.pack("<I", len(body)) + body


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


@dataclass
class SamHeader:
    """Minimal @HD/@PG/@RG header model."""

    version: str = "1.6"
    sort_order: str = "unknown"
    programs: list[dict] = field(default_factory=list)
    read_groups: list[dict] = field(default_factory=list)
    references: list[tuple[str, int]] = field(default_factory=list)
    comments: list[str] = field(default_factory=list)

    def to_text(self) -> str:
        lines = [f"@HD\tVN:{self.version}\tSO:{self.sort_order}"]
        for name, length in self.references:
            lines.append(f"@SQ\tSN:{name}\tLN:{length}")
        for rg in self.read_groups:
            parts = ["@RG"] + [f"{k}:{v}" for k, v in rg.items()]
            lines.append("\t".join(parts))
        for pg in self.programs:
            parts = ["@PG"] + [f"{k}:{v}" for k, v in pg.items()]
            lines.append("\t".join(parts))
        for c in self.comments:
            lines.append(f"@CO\t{c}")
        return "\n".join(lines) + "\n"

    def ref_ids(self) -> dict[str, int]:
        return {name: i for i, (name, _) in enumerate(self.references)}


class BamWriter:
    """Unsorted BAM writer over BGZF. With ``index=True`` a BAI builder
    tracks every record's bin and virtual-offset span (hts_file.cpp:446-509
    writes the .bai during its final sorted merge the same way); call
    ``write_index(fh)`` after the records."""

    def __init__(
        self,
        fileobj: BinaryIO,
        header: SamHeader,
        level: int = 6,
        threads: int | None = None,
        index: bool = False,
    ):
        if threads is None:
            # parallel BGZF compression (htslib bgzf_mt analogue), but for an
            # index, whose per-record virtual offsets would drain every block
            threads = 0 if index else min(8, os.cpu_count() or 1)
        self._bgzf = BgzfWriter(fileobj, level=level, threads=threads)
        self._ref_ids = header.ref_ids()
        text = header.to_text().encode()
        blob = b"BAM\x01" + struct.pack("<i", len(text)) + text
        blob += struct.pack("<i", len(header.references))
        for name, length in header.references:
            nb = name.encode() + b"\x00"
            blob += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._bgzf.write(blob)
        # end the header on a block boundary, so record blocks from several
        # writers can be concatenated without re-encoding
        self._bgzf.flush()
        self.records_written = 0
        self._bai = None
        if index:
            from dorado_tpu_torch.io.bai import BaiBuilder

            self._bai = BaiBuilder(len(header.references))

    def write(self, rec: SamRecord) -> None:
        if self._bai is None:
            self._bgzf.write(encode_bam_record(rec, self._ref_ids))
        else:
            from dorado_tpu_torch.io.bai import cigar_ref_span

            v0 = self._bgzf.virtual_offset()
            self._bgzf.write(encode_bam_record(rec, self._ref_ids))
            v1 = self._bgzf.virtual_offset()
            tid = self._ref_ids.get(rec.rname, -1)
            beg = rec.pos - 1
            if tid < 0 or beg < 0:
                self._bai.add(-1, -1, -1, v0, v1, False)
            else:
                self._bai.add(tid, beg, beg + cigar_ref_span(rec.cigar), v0, v1,
                              not (rec.flag & 4))
        self.records_written += 1

    def write_index(self, fh: BinaryIO) -> None:
        if self._bai is None:
            raise ValueError("BamWriter was not constructed with index=True")
        self._bai.write(fh)

    def close(self) -> None:
        self._bgzf.close()


class SamWriter:
    def __init__(self, fileobj: TextIO, header: SamHeader):
        self._fh = fileobj
        self._fh.write(header.to_text())
        self.records_written = 0

    def write(self, rec: SamRecord) -> None:
        self._fh.write(rec.to_sam_line() + "\n")
        self.records_written += 1

    def close(self) -> None:
        self._fh.flush()


class FastqWriter:
    """FASTQ with the read-level tags dorado puts in the description line."""

    _TAGS = ("qs", "du", "ns", "ts", "ch", "st", "RG")

    def __init__(self, fileobj: TextIO, header: SamHeader | None = None):
        self._fh = fileobj
        self.records_written = 0

    def write(self, rec: SamRecord) -> None:
        tags = [rec.tag_string(t) for t in rec.tags if t.tag in self._TAGS]
        desc = ("\t" + "\t".join(tags)) if tags else ""
        self._fh.write(f"@{rec.qname}{desc}\n{rec.seq}\n+\n{rec.qual}\n")
        self.records_written += 1

    def close(self) -> None:
        self._fh.flush()
