"""CRAM 3.0 writer and reader.

Port of ``dorado_tpu/io/cram.py`` over the port's own record model
(``io/sam.py``), in place of the reference's htslib CRAM output
(dorado/hts_utils/include/hts_utils/hts_file.h:16-76, OutputMode::CRAM;
dorado/hts_utils/hts_file.cpp). Host code, no kernel:

- **Writer** (``CramWriter``): spec-conformant CRAM 3.0. Without
  ``ref_seqs`` in *non-reference* mode (preservation map RR=false, the
  htslib ``no_ref`` mode): read bases are carried by 'b'/'I'/'S' features
  (mapped) or the BA series (unmapped), so the output decodes without a
  reference FASTA. With ``ref_seqs``, reference-based slices (RR=true) for
  single-contig slices. Every data series uses an EXTERNAL encoding into its
  own block: rANS 4x8 by default (htslib's CRAM 3.0 codec, order-1 for large
  streams, ``io/rans.py``), gzip with ``rans=False``.
- **Reader** (``CramReader``): decodes what the writer emits plus the
  common htslib patterns needed for round-trips: EXTERNAL int/byte,
  BYTE_ARRAY_STOP, BYTE_ARRAY_LEN(EXTERNAL/EXTERNAL), constant HUFFMAN;
  block methods raw / gzip / bzip2 / lzma / rANS 4x8 / rANS Nx16.

The bytes after the 26-byte file definition equal the JAX package's writer's
on the same records, with one exception: a base of an RR=true record at or
past its contig's end is an explicit 'b' feature here, where the JAX writer
takes it for an implied match against 'N', which its reader cannot give back.
The file definition's 20-byte id names this package.

Container/slice/record layouts follow the CRAM 3.0 specification; the EOF
container is the spec's fixed 38-byte v3 marker.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field
from typing import BinaryIO

from dorado_tpu_torch.io.rans import rans4x8_decode, rans4x8_encode, ransNx16_decode
from dorado_tpu_torch.io.sam import SamHeader, SamRecord, SamTag

CRAM_MAGIC = b"CRAM"
CRAM_EOF = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001000100ee63014b"
)

# block compression methods
RAW, GZIP, BZIP2, LZMA, RANS4x8, RANSNx16, ARITH, FQZ, TOK3 = range(9)
# block content types
FILE_HEADER, COMPRESSION_HEADER, SLICE_HEADER, _RESERVED, EXTERNAL, CORE = range(6)

# CF record flags
CF_QS_PRESERVED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
# "decode SEQ as '*'" (CRAM spec CF bit 3): set for mapped records written
# with unknown bases (e.g. secondary alignments); their cigar features
# carry N-placeholder payloads so alignment structure round-trips
CF_NO_SEQ = 0x8

_SEQS_PER_SLICE = 4096
# the 20-byte file id of the file definition (the JAX writer puts its own name)
FILE_ID = b"dorado_tpu_torch"


# ----------------------------------------------------------------------
# varint codecs
# ----------------------------------------------------------------------


def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes(
        [0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F]
    )


def write_ltf8(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 1 << 14:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 1 << 21:
        return bytes([0xC0 | (v >> 16)]) + v.to_bytes(3, "big")[1:]
    if v < 1 << 28:
        return bytes([0xE0 | (v >> 24)]) + v.to_bytes(4, "big")[1:]
    if v < 1 << 35:
        return bytes([0xF0 | (v >> 32)]) + v.to_bytes(5, "big")[1:]
    if v < 1 << 42:
        return bytes([0xF8 | (v >> 40)]) + v.to_bytes(6, "big")[1:]
    if v < 1 << 49:
        return bytes([0xFC | (v >> 48)]) + v.to_bytes(7, "big")[1:]
    if v < 1 << 56:
        return bytes([0xFE]) + v.to_bytes(7, "big")
    return bytes([0xFF]) + v.to_bytes(8, "big")


class ByteReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated CRAM stream")
        self.pos += n
        return out

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def itf8(self) -> int:
        b0 = self.byte()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x7F) << 8) | self.byte()
        elif b0 < 0xE0:
            v = ((b0 & 0x3F) << 16) | (self.byte() << 8) | self.byte()
        elif b0 < 0xF0:
            v = (
                ((b0 & 0x1F) << 24)
                | (self.byte() << 16)
                | (self.byte() << 8)
                | self.byte()
            )
        else:
            v = (
                ((b0 & 0x0F) << 28)
                | (self.byte() << 20)
                | (self.byte() << 12)
                | (self.byte() << 4)
                | (self.byte() & 0x0F)
            )
        # itf8 stores 32-bit values; interpret as signed
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        b0 = self.byte()
        if b0 < 0x80:
            return b0
        for k, mask in ((1, 0xC0), (2, 0xE0), (3, 0xF0), (4, 0xF8), (5, 0xFC), (6, 0xFE)):
            if b0 < mask:
                hi = b0 & (0xFF >> (k + 1))
                v = hi
                for _ in range(k):
                    v = (v << 8) | self.byte()
                return v - (1 << 64) if v >= (1 << 63) else v
        if b0 == 0xFE:
            v = int.from_bytes(self.read(7), "big")
        else:
            v = int.from_bytes(self.read(8), "big")
        return v - (1 << 64) if v >= (1 << 63) else v


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------


def write_block(
    ctype: int, content_id: int, data: bytes, method: int | None = None
) -> bytes:
    if method is None:
        method = GZIP if len(data) > 64 else RAW
    if method == RANS4x8:
        # htslib's default codec for CRAM 3.0 data series: order-1 for the
        # large entropy-rich streams (quality-class sizes), order-0
        # otherwise; fall back to gzip/raw when rANS doesn't win (tiny or
        # incompressible blocks)
        if len(data) < 64:
            method = RAW
        else:
            order = 1 if len(data) >= 4096 else 0
            comp = rans4x8_encode(data, order=order)
            # only small blocks also try gzip: on >=4 KiB entropy-rich
            # data series order-1 rANS reliably wins, and running both
            # codecs doubled the CRAM write CPU cost; below that (or when
            # rANS barely compresses) gzip still gets a shot
            if len(data) < 4096 or len(comp) > 0.9 * len(data):
                gz = gzip.compress(data, 6)
                if len(gz) < len(comp):
                    method, comp = GZIP, gz
            if len(data) <= len(comp):
                method, comp = RAW, data
    if method == GZIP:
        comp = gzip.compress(data, 6)
        if len(comp) >= len(data):
            method, comp = RAW, data
    elif method == RAW:
        comp = data
    elif method != RANS4x8:
        raise ValueError(f"writer does not emit method {method}")
    body = (
        bytes([method, ctype])
        + write_itf8(content_id)
        + write_itf8(len(comp))
        + write_itf8(len(data))
        + comp
    )
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return body + struct.pack("<I", crc)


@dataclass
class Block:
    method: int
    ctype: int
    content_id: int
    data: bytes  # uncompressed


def read_block(r: ByteReader) -> Block:
    start = r.pos
    method = r.byte()
    ctype = r.byte()
    content_id = r.itf8()
    comp_size = r.itf8()
    raw_size = r.itf8()
    payload = r.read(comp_size)
    crc_calc = zlib.crc32(r.data[start : r.pos]) & 0xFFFFFFFF
    (crc_stored,) = struct.unpack("<I", r.read(4))
    if crc_calc != crc_stored:
        raise ValueError("CRAM block CRC mismatch")
    if method == RAW:
        data = payload
    elif method == GZIP:
        data = gzip.decompress(payload)
    elif method == BZIP2:
        import bz2

        data = bz2.decompress(payload)
    elif method == LZMA:
        import lzma

        data = lzma.decompress(payload)
    elif method == RANS4x8:
        data = rans4x8_decode(bytes(payload))
    elif method == RANSNx16:
        data = ransNx16_decode(bytes(payload))
    else:
        raise NotImplementedError(
            f"CRAM block compression method {method} (arith/fqzcomp/tok3) "
            "is not supported by this reader"
        )
    if len(data) != raw_size:
        raise ValueError("CRAM block size mismatch")
    return Block(method, ctype, content_id, data)


# ----------------------------------------------------------------------
# container header
# ----------------------------------------------------------------------


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_bases: int
    n_blocks: int
    landmarks: list[int]


def write_container_header(h: ContainerHeader) -> bytes:
    body = struct.pack("<i", h.length)
    body += write_itf8(h.ref_id)
    body += write_itf8(h.start)
    body += write_itf8(h.span)
    body += write_itf8(h.n_records)
    body += write_ltf8(h.record_counter)
    body += write_ltf8(h.n_bases)
    body += write_itf8(h.n_blocks)
    body += write_itf8(len(h.landmarks))
    for lm in h.landmarks:
        body += write_itf8(lm)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return body + struct.pack("<I", crc)


def read_container_header(r: ByteReader) -> ContainerHeader:
    start = r.pos
    (length,) = struct.unpack("<i", r.read(4))
    ref_id = r.itf8()
    astart = r.itf8()
    span = r.itf8()
    n_records = r.itf8()
    record_counter = r.ltf8()
    n_bases = r.ltf8()
    n_blocks = r.itf8()
    n_landmarks = r.itf8()
    landmarks = [r.itf8() for _ in range(n_landmarks)]
    crc_calc = zlib.crc32(r.data[start : r.pos]) & 0xFFFFFFFF
    (crc_stored,) = struct.unpack("<I", r.read(4))
    if crc_calc != crc_stored:
        raise ValueError("CRAM container header CRC mismatch")
    return ContainerHeader(
        length, ref_id, astart, span, n_records, record_counter, n_bases, n_blocks,
        landmarks,
    )


# ----------------------------------------------------------------------
# encodings
# ----------------------------------------------------------------------

NULL_CODEC, EXTERNAL_CODEC, _GOLOMB, HUFFMAN, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP, BETA = (
    0, 1, 2, 3, 4, 5, 6,
)


def enc_external(cid: int) -> bytes:
    params = write_itf8(cid)
    return write_itf8(EXTERNAL_CODEC) + write_itf8(len(params)) + params


def enc_byte_array_stop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + write_itf8(cid)
    return write_itf8(BYTE_ARRAY_STOP) + write_itf8(len(params)) + params


def enc_byte_array_len(len_cid: int, val_cid: int) -> bytes:
    params = enc_external(len_cid) + enc_external(val_cid)
    return write_itf8(BYTE_ARRAY_LEN) + write_itf8(len(params)) + params


@dataclass
class Encoding:
    codec: int
    # EXTERNAL: cid; BYTE_ARRAY_STOP: (stop, cid);
    # BYTE_ARRAY_LEN: (len Encoding, val Encoding); HUFFMAN: (symbols, lens)
    params: object

    @staticmethod
    def parse(r: ByteReader) -> "Encoding":
        codec = r.itf8()
        plen = r.itf8()
        sub = ByteReader(r.read(plen))
        if codec == NULL_CODEC:
            return Encoding(codec, None)
        if codec == EXTERNAL_CODEC:
            return Encoding(codec, sub.itf8())
        if codec == BYTE_ARRAY_STOP:
            stop = sub.byte()
            return Encoding(codec, (stop, sub.itf8()))
        if codec == BYTE_ARRAY_LEN:
            return Encoding(codec, (Encoding.parse(sub), Encoding.parse(sub)))
        if codec == HUFFMAN:
            nsym = sub.itf8()
            syms = [sub.itf8() for _ in range(nsym)]
            nlen = sub.itf8()
            lens = [sub.itf8() for _ in range(nlen)]
            return Encoding(codec, (syms, lens))
        raise NotImplementedError(f"CRAM codec {codec} unsupported by this reader")


# ----------------------------------------------------------------------
# compression header
# ----------------------------------------------------------------------


@dataclass
class CompressionHeader:
    rn_preserved: bool = True
    ap_delta: bool = False
    rr: bool = False
    # substitution matrix (5 bytes, one per ref base ACGTN; each byte packs
    # the 2-bit substitution codes of the other 4 bases in ACGTN order)
    sm: bytes = b"\x1b" * 5
    td: list[list[tuple[str, str]]] = field(default_factory=lambda: [[]])
    ds: dict[str, Encoding] = field(default_factory=dict)
    tag_enc: dict[int, Encoding] = field(default_factory=dict)


# canonical substitution matrix: codes 0..3 assigned to the non-ref bases
# in ACGTN order (byte 0b00_01_10_11 = 0x1b for every ref base)
_SM_DEFAULT = b"\x1b" * 5
_SM_BASES = "ACGTN"


def _sub_code(sm: bytes, ref_base: str, read_base: str) -> int | None:
    """2-bit substitution code for read_base given ref_base, or None if the
    pair is not representable (non-ACGTN base)."""
    ri = _SM_BASES.find(ref_base)
    ci = _SM_BASES.find(read_base)
    if ri < 0 or ci < 0 or ref_base == read_base:
        return None
    others = [b for b in _SM_BASES if b != ref_base]
    k = others.index(read_base)
    return (sm[ri] >> (2 * (3 - k))) & 3


def _sub_base(sm: bytes, ref_base: str, code: int) -> str:
    ri = _SM_BASES.find(ref_base)
    if ri < 0:
        ref_base, ri = "N", 4
    others = [b for b in _SM_BASES if b != ref_base]
    for k, b in enumerate(others):
        if (sm[ri] >> (2 * (3 - k))) & 3 == code:
            return b
    return "N"


def _map_bytes(entries: list[tuple[bytes, bytes]]) -> bytes:
    body = write_itf8(len(entries)) + b"".join(k + v for k, v in entries)
    return write_itf8(len(body)) + body


def build_compression_header(
    ds_entries: list[tuple[str, bytes]],
    tag_entries: list[tuple[int, bytes]],
    td_lines: list[bytes],
    rr: bool = False,
) -> bytes:
    td_blob = b"".join(line + b"\x00" for line in td_lines)
    entries = [
        (b"RN", b"\x01"),
        (b"AP", b"\x00"),
        (b"RR", b"\x01" if rr else b"\x00"),
    ]
    if rr:
        entries.append((b"SM", _SM_DEFAULT))
    entries.append((b"TD", write_itf8(len(td_blob)) + td_blob))
    pres = _map_bytes(entries)
    ds = _map_bytes([(k.encode(), v) for k, v in ds_entries])
    tags = _map_bytes([(write_itf8(k), v) for k, v in tag_entries])
    return pres + ds + tags


def parse_compression_header(data: bytes) -> CompressionHeader:
    r = ByteReader(data)
    out = CompressionHeader()
    # preservation map
    r.itf8()  # size
    for _ in range(r.itf8()):
        key = r.read(2)
        if key == b"RN":
            out.rn_preserved = bool(r.byte())
        elif key == b"AP":
            out.ap_delta = bool(r.byte())
        elif key == b"RR":
            out.rr = bool(r.byte())
        elif key == b"SM":
            out.sm = r.read(5)
        elif key == b"TD":
            blob = r.read(r.itf8())
            out.td = []
            for line in blob.split(b"\x00")[:-1] if blob else [b""]:
                entries = [
                    (line[i : i + 2].decode(), chr(line[i + 2]))
                    for i in range(0, len(line), 3)
                ]
                out.td.append(entries)
            if not out.td:
                out.td = [[]]
        else:
            raise ValueError(f"unknown preservation key {key!r}")
    # data series encodings
    r.itf8()
    for _ in range(r.itf8()):
        key = r.read(2).decode()
        out.ds[key] = Encoding.parse(r)
    # tag encodings
    r.itf8()
    for _ in range(r.itf8()):
        key = r.itf8()
        out.tag_enc[key] = Encoding.parse(r)
    return out


# ----------------------------------------------------------------------
# slice header
# ----------------------------------------------------------------------


@dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: list[int]
    embedded_ref_id: int = -1
    md5: bytes = b"\x00" * 16


def write_slice_header(s: SliceHeader) -> bytes:
    body = write_itf8(s.ref_id)
    body += write_itf8(s.start)
    body += write_itf8(s.span)
    body += write_itf8(s.n_records)
    body += write_ltf8(s.record_counter)
    body += write_itf8(s.n_blocks)
    body += write_itf8(len(s.content_ids))
    for cid in s.content_ids:
        body += write_itf8(cid)
    body += write_itf8(s.embedded_ref_id)
    body += s.md5
    return body


def parse_slice_header(data: bytes) -> SliceHeader:
    r = ByteReader(data)
    ref_id = r.itf8()
    start = r.itf8()
    span = r.itf8()
    n_records = r.itf8()
    record_counter = r.ltf8()
    n_blocks = r.itf8()
    n_ids = r.itf8()
    ids = [r.itf8() for _ in range(n_ids)]
    embedded = r.itf8()
    md5 = r.read(16)
    return SliceHeader(
        ref_id, start, span, n_records, record_counter, n_blocks, ids, embedded, md5
    )


# ----------------------------------------------------------------------
# data series streams (writer side)
# ----------------------------------------------------------------------


class _IntStream:
    """EXTERNAL ITF8 value stream."""

    def __init__(self):
        self.buf = bytearray()

    def put(self, v: int) -> None:
        self.buf += write_itf8(v)


class _ByteStream:
    def __init__(self):
        self.buf = bytearray()

    def put(self, b: bytes) -> None:
        self.buf += b


_TAG_FIXED = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


def _tag_value_bytes(t: SamTag) -> bytes:
    """BAM-layout value bytes for one aux tag (no tag/type prefix)."""
    if t.type == "Z":
        return str(t.value).encode() + b"\x00"
    if t.type == "H":
        return str(t.value).encode() + b"\x00"
    if t.type == "A":
        return str(t.value)[:1].encode()
    if t.type == "f":
        return struct.pack("<f", float(t.value))
    if t.type in "cCsSiI":
        fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}[t.type]
        return struct.pack(fmt, int(t.value))
    if t.type == "B":
        import numpy as np

        sub = t.subtype
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
        arr = np.asarray(t.value)
        return (
            sub.encode()
            + struct.pack("<I", len(arr))
            + struct.pack(f"<{len(arr)}{fmt}", *[v for v in arr.tolist()])
        )
    raise ValueError(f"unsupported tag type {t.type}")


def _tag_from_bytes(tag: str, typ: str, r: ByteReader) -> SamTag:
    if typ in ("Z", "H"):
        end = r.data.index(0, r.pos)
        s = r.data[r.pos : end].decode()
        r.pos = end + 1
        return SamTag(tag, typ, s)
    if typ == "A":
        return SamTag(tag, "A", r.read(1).decode())
    if typ == "f":
        return SamTag(tag, "f", struct.unpack("<f", r.read(4))[0])
    if typ in "cCsSiI":
        fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}[typ]
        n = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4}[typ]
        return SamTag(tag, typ, struct.unpack(fmt, r.read(n))[0])
    if typ == "B":
        import numpy as np

        sub = r.read(1).decode()
        (cnt,) = struct.unpack("<I", r.read(4))
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
        vals = struct.unpack(f"<{cnt}{fmt}", r.read(cnt * struct.calcsize(fmt)))
        return SamTag(tag, "B", np.asarray(vals), subtype=sub)
    raise ValueError(f"unsupported tag type {typ}")


def _parse_cigar(cigar: str) -> list[tuple[int, str]]:
    ops = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            ops.append((int(num), ch))
            num = ""
    return ops


# series ids (writer's fixed assignment)
_SERIES_IDS = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "RN": 7, "MF": 8,
    "NS": 9, "NP": 10, "TS": 11, "NF": 12, "TL": 13, "FN": 14, "FC": 15,
    "FP": 16, "DL": 17, "BB": 18, "QQ": 19, "BS": 20, "IN": 21, "RS": 22,
    "PD": 23, "HC": 24, "SC": 25, "MQ": 26, "BA": 27, "QS": 28, "TLEN": 29,
    "BBLEN": 30, "QQLEN": 31, "INLEN": 32, "SCLEN": 33,
}
_TAG_ID_BASE = 100


class CramWriter:
    """Streams SamRecords into CRAM 3.0 containers.

    Without ``ref_seqs``: non-reference mode (preservation map RR=false,
    htslib's ``no_ref``) — read bases are carried verbatim. With
    ``ref_seqs`` (dict rname -> sequence): reference-based slices
    (RR=true, htslib's default for aligned output) — mapped reads store
    only their differences from the reference ('X' substitution features
    with the canonical substitution matrix, I/S/D/N/H/P features for the
    rest), which is several-fold smaller on low-divergence alignments.
    The slice header carries the MD5 of the spanned reference region.
    """

    def __init__(
        self,
        fileobj: BinaryIO,
        header: SamHeader,
        rans: bool = True,
        ref_seqs: dict[str, str] | None = None,
    ):
        # rans=True (default, as in htslib) compresses the external
        # data-series blocks with rANS 4x8 (order-1 for large streams) via
        # the from-scratch coders in io/rans.py; headers stay gzip/raw.
        # Round-trips through this module's own reader.
        self.f = fileobj
        self.header = header
        self.ref_seqs = ref_seqs
        self._ext_method = RANS4x8 if rans else None
        self.ref_ids = header.ref_ids()
        self.rg_ids = {
            rg.get("ID"): i for i, rg in enumerate(header.read_groups)
        }
        self._pending: list[SamRecord] = []
        self._record_counter = 0
        self._wrote_header = False

    # -- file-level --------------------------------------------------

    def _write_file_header(self) -> None:
        self.f.write(CRAM_MAGIC + bytes([3, 0]) + FILE_ID.ljust(20, b"\x00"))
        text = self.header.to_text().encode()
        data = struct.pack("<i", len(text)) + text
        block = write_block(FILE_HEADER, 0, data)
        ch = ContainerHeader(
            length=len(block), ref_id=0, start=0, span=0, n_records=0,
            record_counter=0, n_bases=0, n_blocks=1, landmarks=[0],
        )
        self.f.write(write_container_header(ch))
        self.f.write(block)
        self._wrote_header = True

    def write(self, rec: SamRecord) -> None:
        if not self._wrote_header:
            self._write_file_header()
        self._pending.append(rec)
        if len(self._pending) >= _SEQS_PER_SLICE:
            self._flush()

    def close(self) -> None:
        if not self._wrote_header:
            self._write_file_header()
        if self._pending:
            self._flush()
        self.f.write(CRAM_EOF)
        self.f.flush()

    # -- container build ---------------------------------------------

    def _flush(self) -> None:
        records = self._pending
        self._pending = []

        ints = {k: _IntStream() for k in _SERIES_IDS}
        bys = {k: _ByteStream() for k in ("RN", "BB", "QQ", "IN", "SC", "BA", "QS")}
        td_lines: list[bytes] = []
        td_index: dict[bytes, int] = {}
        tag_streams: dict[int, tuple[_IntStream, _ByteStream]] = {}

        ref_set = {self.ref_ids.get(r.rname, -1) for r in records}
        multi_ref = len(ref_set) > 1
        slice_ref = -2 if multi_ref else ref_set.pop()
        n_bases = 0

        # reference-based slice (RR=true) when a single-reference slice's
        # sequence is available; mixed/multi-ref slices stay verbatim
        ref_names = {i: n for n, i in self.ref_ids.items()}
        slice_refseq = None
        if (
            self.ref_seqs is not None
            and not multi_ref
            and slice_ref >= 0
            and ref_names.get(slice_ref) in self.ref_seqs
        ):
            slice_refseq = self.ref_seqs[ref_names[slice_ref]]
        use_ref = slice_refseq is not None
        ref_lo, ref_hi = None, 0  # spanned reference region (1-based)

        for rec in records:
            seq = rec.seq if rec.seq != "*" else ""
            n_bases += len(seq)
            mapped = not (rec.flag & 0x4) and rec.rname != "*"
            # mapped records with unknown bases (SEQ '*' but a real cigar,
            # e.g. secondary alignments): CF_NO_SEQ + N-placeholder
            # payloads keep the alignment structure without inventing
            # reference bases on decode
            no_seq = mapped and not seq and rec.cigar != "*"
            if no_seq:
                seq = "N" * sum(
                    n for n, op in _parse_cigar(rec.cigar) if op in "MIS=X"
                )
            tags = [t for t in rec.tags if t.tag != "RG"]
            rg_tag = next((t for t in rec.tags if t.tag == "RG"), None)

            ints["BF"].put(rec.flag)
            cf = CF_QS_PRESERVED | CF_DETACHED | (CF_NO_SEQ if no_seq else 0)
            ints["CF"].put(cf)
            if multi_ref:
                ints["RI"].put(self.ref_ids.get(rec.rname, -1))
            ints["RL"].put(len(seq))
            ints["AP"].put(rec.pos)
            ints["RG"].put(
                self.rg_ids.get(str(rg_tag.value), -1) if rg_tag is not None else -1
            )
            bys["RN"].put(rec.qname.encode() + b"\x00")
            # detached mate data
            mf = (0x1 if rec.flag & 0x20 else 0) | (0x2 if rec.flag & 0x8 else 0)
            ints["MF"].put(mf)
            rnext = rec.rname if rec.rnext == "=" else rec.rnext
            ints["NS"].put(self.ref_ids.get(rnext, -1))
            ints["NP"].put(rec.pnext)
            ints["TS"].put(rec.tlen)

            line = b"".join(
                t.tag.encode() + (t.type if t.type != "H" else "H").encode()
                for t in tags
            )
            tl = td_index.setdefault(line, len(td_index))
            if tl == len(td_lines):
                td_lines.append(line)
            ints["TL"].put(tl)
            for t in tags:
                key = (ord(t.tag[0]) << 16) | (ord(t.tag[1]) << 8) | ord(t.type)
                if key not in tag_streams:
                    tag_streams[key] = (_IntStream(), _ByteStream())
                lst, vst = tag_streams[key]
                vb = _tag_value_bytes(t)
                lst.put(len(vb))
                vst.put(vb)

            if mapped:
                ref_span = self._put_features(
                    rec, seq, ints, bys,
                    slice_refseq if use_ref and not no_seq else None,
                )
                ints["MQ"].put(rec.mapq)
                if use_ref and ref_span:
                    lo, hi = rec.pos, rec.pos + ref_span - 1
                    ref_lo = lo if ref_lo is None else min(ref_lo, lo)
                    ref_hi = max(ref_hi, hi)
            else:
                bys["BA"].put(seq.encode())
            if rec.qual != "*" and rec.qual:
                bys["QS"].put(bytes(min(ord(c) - 33, 93) for c in rec.qual))
            else:
                bys["QS"].put(b"\xff" * len(seq))

        # --- encoding map
        ds_entries: list[tuple[str, bytes]] = []

        def ext(name, sid_name=None):
            ds_entries.append((name, enc_external(_SERIES_IDS[sid_name or name])))

        for name in ("BF", "CF", "RL", "AP", "RG", "MF", "NS", "NP", "TS", "TL",
                     "FN", "FC", "FP", "DL", "RS", "PD", "HC", "MQ", "BA", "QS",
                     "BS"):
            ext(name)
        if multi_ref:
            ext("RI")
        ds_entries.append(
            ("RN", enc_byte_array_stop(0, _SERIES_IDS["RN"]))
        )
        ds_entries.append(
            ("BB", enc_byte_array_len(_SERIES_IDS["BBLEN"], _SERIES_IDS["BB"]))
        )
        ds_entries.append(
            ("QQ", enc_byte_array_len(_SERIES_IDS["QQLEN"], _SERIES_IDS["QQ"]))
        )
        ds_entries.append(
            ("IN", enc_byte_array_len(_SERIES_IDS["INLEN"], _SERIES_IDS["IN"]))
        )
        ds_entries.append(
            ("SC", enc_byte_array_len(_SERIES_IDS["SCLEN"], _SERIES_IDS["SC"]))
        )
        tag_entries = [
            (key, enc_byte_array_len(_TAG_ID_BASE + 2 * i, _TAG_ID_BASE + 2 * i + 1))
            for i, key in enumerate(tag_streams)
        ]
        comp_data = build_compression_header(
            ds_entries, tag_entries, td_lines, rr=use_ref
        )

        # --- external blocks
        blocks: list[tuple[int, bytes]] = []  # (content id, data)
        for name, sid in _SERIES_IDS.items():
            if name in bys:
                data = bytes(bys[name].buf)
            elif name in ints:
                data = bytes(ints[name].buf)
            else:
                continue
            if data:
                blocks.append((sid, data))
        for i, (key, (lst, vst)) in enumerate(tag_streams.items()):
            blocks.append((_TAG_ID_BASE + 2 * i, bytes(lst.buf)))
            blocks.append((_TAG_ID_BASE + 2 * i + 1, bytes(vst.buf)))

        core = write_block(CORE, 0, b"", method=RAW)
        ext_blocks = [
            write_block(EXTERNAL, cid, data, method=self._ext_method)
            for cid, data in blocks
        ]

        sl_start, sl_span, sl_md5 = 0, 0, b"\x00" * 16
        if use_ref and ref_lo is not None:
            import hashlib

            sl_start = ref_lo
            sl_span = ref_hi - ref_lo + 1
            sl_md5 = hashlib.md5(
                slice_refseq[ref_lo - 1 : ref_hi].encode()
            ).digest()
        sh = SliceHeader(
            ref_id=slice_ref,
            start=sl_start,
            span=sl_span,
            n_records=len(records),
            record_counter=self._record_counter,
            n_blocks=1 + len(ext_blocks),
            content_ids=[cid for cid, _ in blocks],
            md5=sl_md5,
        )
        slice_block = write_block(SLICE_HEADER, 0, write_slice_header(sh), method=RAW)
        comp_block = write_block(COMPRESSION_HEADER, 0, comp_data)

        payload = comp_block + slice_block + core + b"".join(ext_blocks)
        landmarks = [len(comp_block)]
        ch = ContainerHeader(
            length=len(payload),
            ref_id=slice_ref,
            start=sl_start,
            span=sl_span,
            n_records=len(records),
            record_counter=self._record_counter,
            n_bases=n_bases,
            n_blocks=2 + 1 + len(ext_blocks),
            landmarks=landmarks,
        )
        self.f.write(write_container_header(ch))
        self.f.write(payload)
        self._record_counter += len(records)

    def _put_features(self, rec, seq, ints, bys, refseq=None) -> int:
        """Cigar -> CRAM features. refseq None: bases carried verbatim
        (RR=false). refseq given: reference-based (RR=true) — aligned
        stretches are implicit, mismatches become 'X' substitution
        features (falling back to single-base 'b' for non-ACGTN pairs).
        Returns the reference span consumed by the record."""
        feats: list[tuple[int, str, object]] = []  # (read pos 1-based, code, value)
        rpos = 1
        refp = rec.pos  # 1-based reference position
        ref_span = 0
        if not seq:
            # seq-less mapped records (e.g. secondary alignments written
            # with SEQ '*'): nothing to diff against the reference — fall
            # back to the verbatim feature path (empty payloads, the
            # pre-RR behaviour; the cigar is not representable without
            # bases in either mode)
            refseq = None
        for n, op in _parse_cigar(rec.cigar) if rec.cigar != "*" else []:
            if op in "M=X" and refseq is not None:
                read_seg = seq[rpos - 1 : rpos - 1 + n]
                ref_seg = refseq[refp - 1 : refp - 1 + n]
                for k in range(n):
                    rb = read_seg[k]
                    if k >= len(ref_seg):
                        # past the contig's end there is no base to imply:
                        # carry the read's own (the JAX writer takes it for
                        # a match against 'N', which no reader gives back)
                        feats.append((rpos + k, "b", rb.encode()))
                        continue
                    fb = ref_seg[k]
                    if rb == fb:
                        continue
                    code = _sub_code(_SM_DEFAULT, fb, rb)
                    if code is None:
                        feats.append((rpos + k, "b", rb.encode()))
                    else:
                        feats.append((rpos + k, "X", code))
                rpos += n
                refp += n
                ref_span += n
            elif op in "M=X":
                feats.append((rpos, "b", seq[rpos - 1 : rpos - 1 + n].encode()))
                rpos += n
                refp += n
                ref_span += n
            elif op == "I":
                feats.append((rpos, "I", seq[rpos - 1 : rpos - 1 + n].encode()))
                rpos += n
            elif op == "S":
                feats.append((rpos, "S", seq[rpos - 1 : rpos - 1 + n].encode()))
                rpos += n
            elif op == "D":
                feats.append((rpos, "D", n))
                refp += n
                ref_span += n
            elif op == "N":
                feats.append((rpos, "N", n))
                refp += n
                ref_span += n
            elif op == "H":
                feats.append((rpos, "H", n))
            elif op == "P":
                feats.append((rpos, "P", n))
            else:
                raise ValueError(f"unsupported cigar op {op}")
        ints["FN"].put(len(feats))
        prev = 0
        for pos, code, val in feats:
            ints["FC"].put(ord(code))
            ints["FP"].put(pos - prev)
            prev = pos
            if code == "b":
                ints["BBLEN"].put(len(val))
                bys["BB"].put(val)
            elif code == "I":
                ints["INLEN"].put(len(val))
                bys["IN"].put(val)
            elif code == "S":
                ints["SCLEN"].put(len(val))
                bys["SC"].put(val)
            elif code == "D":
                ints["DL"].put(val)
            elif code == "N":
                ints["RS"].put(val)
            elif code == "H":
                ints["HC"].put(val)
            elif code == "P":
                ints["PD"].put(val)
            elif code == "X":
                ints["BS"].put(val)
        return ref_span


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------


class _SeriesReader:
    """Decodes one data series from its encoding + external blocks."""

    def __init__(self, enc: Encoding, ext: dict[int, ByteReader]):
        self.enc = enc
        self.ext = ext

    def read_int(self) -> int:
        e = self.enc
        if e.codec == EXTERNAL_CODEC:
            return self.ext[e.params].itf8()
        if e.codec == HUFFMAN:
            syms, lens = e.params
            if len(syms) == 1 and lens == [0]:
                return syms[0]
            raise NotImplementedError("only constant HUFFMAN supported")
        raise NotImplementedError(f"int read from codec {e.codec}")

    def read_byte(self) -> int:
        e = self.enc
        if e.codec == EXTERNAL_CODEC:
            return self.ext[e.params].byte()
        if e.codec == HUFFMAN:
            syms, lens = e.params
            if len(syms) == 1 and lens == [0]:
                return syms[0]
        raise NotImplementedError(f"byte read from codec {e.codec}")

    def read_bytes(self, length_hint: int | None = None) -> bytes:
        e = self.enc
        if e.codec == BYTE_ARRAY_STOP:
            stop, cid = e.params
            r = self.ext[cid]
            end = r.data.index(stop, r.pos)
            out = r.data[r.pos : end]
            r.pos = end + 1
            return out
        if e.codec == BYTE_ARRAY_LEN:
            len_enc, val_enc = e.params
            n = _SeriesReader(len_enc, self.ext).read_int()
            val = val_enc
            if n == 0:
                # zero-length payloads (e.g. an 'S' feature of a SEQ-less
                # record) may have no external value block at all
                return b""
            if val.codec == EXTERNAL_CODEC:
                return self.ext[val.params].read(n)
            raise NotImplementedError("BYTE_ARRAY_LEN value codec")
        if e.codec == EXTERNAL_CODEC:
            if length_hint is None:
                raise ValueError("length required for EXTERNAL byte array")
            return self.ext[e.params].read(length_hint)
        raise NotImplementedError(f"bytes read from codec {e.codec}")


class CramReader:
    """Decodes CRAM files produced by CramWriter (and compatible layouts).

    ``ref_seqs`` (dict rname -> sequence) is required to decode
    reference-based (RR=true) slices; with it, missing MD/NM tags on
    mapped records are reconstructed from the reference (htslib fills
    both in on CRAM decode the same way)."""

    def __init__(self, path_or_bytes, ref_seqs: dict[str, str] | None = None):
        self.ref_seqs = ref_seqs
        if isinstance(path_or_bytes, (bytes, bytearray)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        self.r = ByteReader(data)
        magic = self.r.read(4)
        if magic != CRAM_MAGIC:
            raise ValueError("not a CRAM file")
        self.major, self.minor = self.r.read(1)[0], self.r.read(1)[0]
        self.r.read(20)  # file id
        # first container: SAM header
        ch = read_container_header(self.r)
        end = self.r.pos + ch.length
        blk = read_block(self.r)
        hr = ByteReader(blk.data)
        (tlen,) = struct.unpack("<i", hr.read(4))
        self.header_text = hr.read(tlen).decode()
        self.r.pos = end
        self.refs = [
            line.split("\t")[1][3:]
            for line in self.header_text.splitlines()
            if line.startswith("@SQ")
        ]
        self.rgs = []
        for line in self.header_text.splitlines():
            if line.startswith("@RG"):
                for f_ in line.split("\t")[1:]:
                    if f_.startswith("ID:"):
                        self.rgs.append(f_[3:])

    def records(self):
        while True:
            if self.r.data[self.r.pos : self.r.pos + len(CRAM_EOF)] == CRAM_EOF:
                return
            if self.r.pos >= len(self.r.data):
                return
            ch = read_container_header(self.r)
            end = self.r.pos + ch.length
            comp_blk = read_block(self.r)
            if comp_blk.ctype != COMPRESSION_HEADER:
                raise ValueError("expected compression header block")
            comp = parse_compression_header(comp_blk.data)
            while self.r.pos < end:
                blk = read_block(self.r)
                if blk.ctype != SLICE_HEADER:
                    raise ValueError("expected slice header block")
                sh = parse_slice_header(blk.data)
                ext: dict[int, ByteReader] = {}
                for _ in range(sh.n_blocks):
                    b = read_block(self.r)
                    if b.ctype == EXTERNAL:
                        ext[b.content_id] = ByteReader(b.data)
                yield from self._decode_slice(comp, sh, ext)
        # not reached

    # -- record decode ------------------------------------------------

    def _decode_slice(self, comp: CompressionHeader, sh: SliceHeader, ext):
        def series(key):
            enc = comp.ds.get(key)
            return _SeriesReader(enc, ext) if enc is not None else None

        s = {k: series(k) for k in (
            "BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
            "NF", "TL", "FN", "FC", "FP", "DL", "BB", "QQ", "BS", "IN", "RS",
            "PD", "HC", "SC", "MQ", "BA", "QS",
        )}
        tag_readers = {
            key: _SeriesReader(enc, ext) for key, enc in comp.tag_enc.items()
        }

        prev_ap = 0
        for _ in range(sh.n_records):
            bf = s["BF"].read_int()
            cf = s["CF"].read_int()
            if sh.ref_id == -2:
                ri = s["RI"].read_int()
            else:
                ri = sh.ref_id
            rl = s["RL"].read_int()
            ap = s["AP"].read_int()
            if comp.ap_delta:
                ap += prev_ap
                prev_ap = ap
            rg = s["RG"].read_int()
            qname = s["RN"].read_bytes().decode() if comp.rn_preserved else ""
            rnext, pnext, tlen = "*", 0, 0
            if cf & CF_DETACHED:
                s["MF"].read_int()
                if not comp.rn_preserved:
                    qname = s["RN"].read_bytes().decode()
                ns = s["NS"].read_int()
                rnext = self.refs[ns] if 0 <= ns < len(self.refs) else "*"
                pnext = s["NP"].read_int()
                tlen = s["TS"].read_int()
            elif cf & CF_MATE_DOWNSTREAM:
                s["NF"].read_int()
            tl = s["TL"].read_int()
            tags = []
            for tag2, typ in comp.td[tl]:
                key = (ord(tag2[0]) << 16) | (ord(tag2[1]) << 8) | ord(typ)
                vb = tag_readers[key].read_bytes()
                tags.append(_tag_from_bytes(tag2, typ, ByteReader(vb)))

            mapped = not (bf & 0x4)
            mapq = 0
            md_nm_ref = None
            if mapped:
                if cf & CF_NO_SEQ:
                    # unknown-bases record: features carry N placeholders
                    # (never reference-diffed); cigar decodes, SEQ is '*'
                    _, cigar = self._decode_features(s, rl)
                    seq = ""
                elif comp.rr:
                    rname_i = self.refs[ri] if 0 <= ri < len(self.refs) else "*"
                    refseq = (self.ref_seqs or {}).get(rname_i)
                    if refseq is None:
                        raise ValueError(
                            f"RR=true slice needs ref_seqs[{rname_i!r}] to decode"
                        )
                    seq, cigar = self._decode_features(
                        s, rl, comp=comp, refseq=refseq, ap=ap
                    )
                    md_nm_ref = refseq
                else:
                    seq, cigar = self._decode_features(s, rl)
                mapq = s["MQ"].read_int()
            else:
                seq = s["BA"].read_bytes(rl).decode() if rl else ""
                cigar = "*"
            if cf & CF_QS_PRESERVED:
                qs = s["QS"].read_bytes(rl)
                qual = (
                    "".join(chr(min(q, 93) + 33) for q in qs)
                    if rl and not all(q == 0xFF for q in qs)
                    else "*"
                )
            else:
                qual = "*"

            if rg >= 0 and rg < len(self.rgs):
                tags.append(SamTag("RG", "Z", self.rgs[rg]))
            if md_nm_ref is not None:
                have = {t.tag for t in tags}
                if "MD" not in have or "NM" not in have:
                    md, nm = compute_md_nm(seq, cigar, md_nm_ref, ap)
                    if "NM" not in have:
                        tags.append(SamTag("NM", "i", nm))
                    if "MD" not in have:
                        tags.append(SamTag("MD", "Z", md))
            yield SamRecord(
                qname=qname,
                flag=bf,
                rname=self.refs[ri] if 0 <= ri < len(self.refs) else "*",
                pos=ap,
                mapq=mapq,
                cigar=cigar,
                rnext=rnext,
                pnext=pnext,
                tlen=tlen,
                seq=seq if seq else "*",
                qual=qual,
                tags=tags,
            )

    def _decode_features(
        self, s, rl: int, comp=None, refseq: str | None = None, ap: int = 0
    ) -> tuple[str, str]:
        fn = s["FN"].read_int()
        cigar_ops: list[tuple[int, str]] = []
        out = []
        rpos = 1
        refp = ap  # 1-based reference position (RR=true decode)
        feats = []
        prev = 0
        for _ in range(fn):
            code = chr(s["FC"].read_byte())
            prev += s["FP"].read_int()
            feats.append((prev, code))
            if code == "b":
                val = s["BB"].read_bytes()
            elif code == "I":
                val = s["IN"].read_bytes()
            elif code == "S":
                val = s["SC"].read_bytes()
            elif code == "X":
                val = s["BS"].read_int()
            elif code == "D":
                val = s["DL"].read_int()
            elif code == "N":
                val = s["RS"].read_int()
            elif code == "H":
                val = s["HC"].read_int()
            elif code == "P":
                val = s["PD"].read_int()
            else:
                raise NotImplementedError(f"CRAM feature {code}")
            feats[-1] = (prev, code, val)

        def add_op(n, op):
            if n <= 0:
                return
            if cigar_ops and cigar_ops[-1][1] == op:
                cigar_ops[-1] = (cigar_ops[-1][0] + n, op)
            else:
                cigar_ops.append((n, op))

        def fill_from_ref(upto_rpos):
            """Implicit matched bases between features (RR=true only)."""
            nonlocal rpos, refp
            n = upto_rpos - rpos
            if n <= 0:
                return
            if refseq is None:
                raise ValueError("gap in CRAM read features without bases")
            out.append(refseq[refp - 1 : refp - 1 + n])
            add_op(n, "M")
            rpos += n
            refp += n

        for pos, code, val in feats:
            if code in ("b", "I", "S"):
                fill_from_ref(pos)
                out.append(val.decode())
                n = len(val)
                add_op(n, {"b": "M", "I": "I", "S": "S"}[code])
                rpos = pos + n
                if code == "b":
                    refp += n
            elif code == "X":
                fill_from_ref(pos)
                rb = refseq[refp - 1] if refseq and refp <= len(refseq) else "N"
                out.append(_sub_base(comp.sm if comp else _SM_DEFAULT, rb, val))
                add_op(1, "M")
                rpos += 1
                refp += 1
            elif code == "D":
                fill_from_ref(pos)
                add_op(val, "D")
                refp += val
            elif code == "N":
                fill_from_ref(pos)
                add_op(val, "N")
                refp += val
            elif code == "H":
                # consume implicit matches up to the clip's read position
                # first, else '90M10H' would decode as '10H90M'
                fill_from_ref(pos)
                add_op(val, "H")
            elif code == "P":
                fill_from_ref(pos)
                add_op(val, "P")
        if refseq is not None:
            fill_from_ref(rl + 1)
        seq = "".join(out)
        if len(seq) < rl:
            # trailing bases with no feature: not produced by our writer
            raise ValueError("CRAM record shorter than RL")
        cigar = "".join(f"{n}{op}" for n, op in cigar_ops) if cigar_ops else "*"
        return seq, cigar


def compute_md_nm(seq: str, cigar: str, refseq: str, pos: int) -> tuple[str, int]:
    """Reconstruct the MD string and NM edit distance for an aligned read
    against its reference (SAMtags spec; htslib regenerates both on CRAM
    decode the same way). ``pos`` is 1-based."""
    md_parts: list[str] = []
    match_run = 0
    nm = 0
    rpos = 0  # 0-based read index
    refp = pos - 1  # 0-based ref index
    for n, op in _parse_cigar(cigar) if cigar != "*" else []:
        if op in "M=X":
            for k in range(n):
                rb = seq[rpos + k]
                fb = refseq[refp + k] if refp + k < len(refseq) else "N"
                if rb == fb:
                    match_run += 1
                else:
                    md_parts.append(str(match_run))
                    md_parts.append(fb)
                    match_run = 0
                    nm += 1
            rpos += n
            refp += n
        elif op == "I":
            nm += n
            rpos += n
        elif op in "SH":
            if op == "S":
                rpos += n
        elif op == "D":
            md_parts.append(str(match_run))
            md_parts.append("^" + refseq[refp : refp + n])
            match_run = 0
            nm += n
            refp += n
        elif op == "N":
            refp += n
    md_parts.append(str(match_run))
    return "".join(md_parts), nm


def scan_structure(path) -> dict:
    """Structural smoke-parse of any CRAM 3.x file: file definition,
    container walk (headers + block headers), EOF detection. Used to
    validate the container framing against htslib-written files whose
    block codecs (rANS etc.) this reader does not decode."""
    with open(path, "rb") as f:
        data = f.read()
    r = ByteReader(data)
    if r.read(4) != CRAM_MAGIC:
        raise ValueError("not a CRAM file")
    major, minor = r.read(1)[0], r.read(1)[0]
    r.read(20)
    containers = 0
    records = 0
    methods = set()
    eof = False
    while r.pos < len(data):
        if data[r.pos : r.pos + len(CRAM_EOF)] == CRAM_EOF:
            eof = True
            break
        ch = read_container_header(r)
        end = r.pos + ch.length
        # walk block headers without decompressing unsupported codecs
        while r.pos < end:
            start = r.pos
            method = r.byte()
            r.byte()
            r.itf8()
            comp_size = r.itf8()
            r.itf8()
            r.read(comp_size)
            r.read(4)  # crc
            methods.add(method)
            assert r.pos > start
        containers += 1
        records += ch.n_records
    return {
        "version": (major, minor),
        "containers": containers,
        "records": records,
        "methods": sorted(methods),
        "eof": eof,
    }
