"""Reading BAM and SAM back: record decoding and aux-tag parsing.

Port of ``dorado_tpu/io/bam_reader.py``, over the port's own BGZF readers
(``io/bgzf.py``) and record model (``io/sam.py``): enough of the BAM spec to
read back BAM output, as ``--resume-from``, ``summary``, ``aligner`` and the
sorted writer's merge do and as the merge of several processes' BAMs
(``parallel.distributed``) re-encodes them, and region queries through a
.bai (``fetch_region``). ``read_records`` also reads CRAM (``io/cram.py``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator

import numpy as np

from dorado_tpu_torch.io.bgzf import BgzfRandomReader, BgzfReader
from dorado_tpu_torch.io.sam import SamRecord, SamTag

_SEQ_LUT_BYTES = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
_CIGAR_OPS = "MIDNSHP=X"
_INT_FORMATS = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}
_ARRAY_FORMATS = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}


def _parse_aux(aux: bytes) -> list[SamTag]:
    tags = []
    p = 0
    while p < len(aux):
        tag = aux[p : p + 2].decode()
        typ = chr(aux[p + 2])
        p += 3
        if typ in "ZH":
            end = aux.index(0, p)
            tags.append(SamTag(tag, "Z", aux[p:end].decode()))
            p = end + 1
        elif typ == "A":
            tags.append(SamTag(tag, "A", chr(aux[p])))
            p += 1
        elif typ == "f":
            tags.append(SamTag(tag, "f", struct.unpack_from("<f", aux, p)[0]))
            p += 4
        elif typ in _INT_FORMATS:
            fmt = _INT_FORMATS[typ]
            tags.append(SamTag(tag, typ, struct.unpack_from(fmt, aux, p)[0]))
            p += struct.calcsize(fmt)
        elif typ == "B":
            sub = chr(aux[p])
            count = struct.unpack_from("<I", aux, p + 1)[0]
            dtype = np.dtype(_ARRAY_FORMATS[sub]).newbyteorder("<")
            end = p + 5 + count * dtype.itemsize
            tags.append(SamTag(tag, "B", np.frombuffer(aux[p + 5 : end], dtype=dtype).copy(),
                               subtype=sub))
            p = end
        else:
            raise ValueError(f"unsupported aux type {typ!r}")
    return tags


def decode_bam_record(block: bytes) -> SamRecord:
    (refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq, _next_refid, next_pos,
     tlen) = struct.unpack_from("<iiBBHHHiiii", block, 0)
    p = 32
    qname = block[p : p + l_read_name - 1].decode()
    p += l_read_name
    cigar_ops = struct.unpack_from(f"<{n_cigar}I", block, p)
    p += 4 * n_cigar
    cigar = "".join(f"{op >> 4}{_CIGAR_OPS[op & 0xF]}" for op in cigar_ops) or "*"
    nib = np.frombuffer(block[p : p + (l_seq + 1) // 2], np.uint8)
    p += (l_seq + 1) // 2
    seq = "*"
    if l_seq:
        nibs = np.empty(2 * len(nib), np.uint8)
        nibs[0::2] = nib >> 4
        nibs[1::2] = nib & 0xF
        seq = _SEQ_LUT_BYTES[nibs[:l_seq]].tobytes().decode()
    qual_raw = block[p : p + l_seq]
    p += l_seq
    qual = "*"
    if l_seq and (not qual_raw or qual_raw[0] != 0xFF):
        qual = (np.minimum(np.frombuffer(qual_raw, np.uint8), 93) + 33).astype(
            np.uint8).tobytes().decode("latin-1")
    return SamRecord(
        qname=qname, flag=flag, rname="*" if refid < 0 else str(refid), pos=pos + 1,
        mapq=mapq, cigar=cigar, rnext="*", pnext=next_pos + 1, tlen=tlen, seq=seq, qual=qual,
        tags=_parse_aux(block[p:]),
    )


def stream_bam(fh) -> tuple[str, list[tuple[str, int]], Iterator[SamRecord]]:
    """(header text, references as (name, length), a lazy iterator of the
    records) of an open BAM file, read one BGZF member at a time."""
    r = BgzfReader(fh)
    if r.read(4) != b"BAM\x01":
        raise ValueError("not a BAM file")
    text = r.read(struct.unpack("<i", r.read(4))[0]).decode()
    refs = []
    for _ in range(struct.unpack("<i", r.read(4))[0]):
        name = r.read(struct.unpack("<i", r.read(4))[0])[:-1].decode()
        refs.append((name, struct.unpack("<i", r.read(4))[0]))

    def records() -> Iterator[SamRecord]:
        while len(raw_size := r.read(4)) == 4:
            rec = decode_bam_record(r.read(struct.unpack("<i", raw_size)[0]))
            if rec.rname != "*":
                idx = int(rec.rname)
                rec.rname = refs[idx][0] if 0 <= idx < len(refs) else "*"
            yield rec

    return text, refs, records()


def iter_bam(path: Path | str) -> Iterator[SamRecord]:
    """The records of a BAM file, one at a time."""
    with open(path, "rb") as fh:
        _, _, records = stream_bam(fh)
        yield from records


def read_bam(path: Path | str) -> tuple[str, list[SamRecord]]:
    """(header text, records) of a BAM file."""
    with open(path, "rb") as fh:
        text, _, records = stream_bam(fh)
        return text, list(records)


def iter_sam(path: Path | str) -> Iterator[SamRecord]:
    """Records of a SAM text file."""
    with open(path) as fh:
        for line in fh:
            if line.startswith("@") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            tags = []
            for tf in f[11:]:
                tag, typ, val = tf.split(":", 2)
                if typ == "i":
                    tags.append(SamTag(tag, "i", int(val)))
                elif typ == "f":
                    tags.append(SamTag(tag, "f", float(val)))
                elif typ == "B":
                    sub, *vals = val.split(",")
                    arr = np.asarray([float(v) if sub == "f" else int(v) for v in vals])
                    tags.append(SamTag(tag, "B", arr, subtype=sub))
                else:
                    tags.append(SamTag(tag, typ, val))
            yield SamRecord(
                qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]), mapq=int(f[4]),
                cigar=f[5], rnext=f[6], pnext=int(f[7]), tlen=int(f[8]), seq=f[9], qual=f[10],
                tags=tags,
            )


def read_records(path: Path | str) -> tuple[str, list[SamRecord]]:
    """(header text, records) of a BAM, SAM or CRAM file. A reference-based
    CRAM (RR=true, as ``aligner -o x.cram`` writes) raises ValueError: no
    reference is passed here, as in the JAX package; read it with
    ``CramReader(path, ref_seqs=...)``."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic == b"CRAM":
        from dorado_tpu_torch.io.cram import CramReader

        reader = CramReader(path)
        return reader.header_text, list(reader.records())
    if magic[:2] == b"\x1f\x8b":
        return read_bam(path)
    header_lines = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("@"):
                break
            header_lines.append(line)
    return "".join(header_lines), list(iter_sam(path))


def fetch_region(
    path: Path | str, rname: str, beg: int, end: int, bai_path: Path | str | None = None
) -> list[SamRecord]:
    """Records overlapping [beg, end) (0-based half-open) on ``rname``,
    located through the .bai index (``<path>.bai`` unless given) —
    samtools-view region semantics over this module's own readers."""
    from dorado_tpu_torch.io.bai import cigar_ref_span, query_chunks, read_bai

    path = Path(path)
    bai_path = Path(bai_path) if bai_path else Path(str(path) + ".bai")
    with open(path, "rb") as fh:
        _, refs, _ = stream_bam(fh)
    tid = [n for n, _ in refs].index(rname)
    with open(bai_path, "rb") as fh:
        bins, linear, _ = read_bai(fh)
    chunks = query_chunks(bins.get(tid, {}), linear.get(tid, []), beg, end)

    out: list[SamRecord] = []
    seen: set[int] = set()
    with open(path, "rb") as fh:
        r = BgzfRandomReader(fh)
        for c0, c1 in chunks:
            if not r.seek_voffset(c0):
                continue
            while r.voffset() < c1:
                v_rec = r.voffset()
                raw_size = r.read(4)
                if len(raw_size) < 4:
                    break
                block = r.read(struct.unpack("<i", raw_size)[0])
                if v_rec in seen:
                    continue
                seen.add(v_rec)
                rec = decode_bam_record(block)
                if rec.rname != "*":
                    idx = int(rec.rname)
                    rec.rname = refs[idx][0] if 0 <= idx < len(refs) else "*"
                if rec.rname != rname or rec.pos <= 0:
                    continue
                b = rec.pos - 1
                if b < end and b + cigar_ref_span(rec.cigar) > beg:
                    out.append(rec)
    return out
