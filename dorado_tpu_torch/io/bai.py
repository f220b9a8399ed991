"""BAI (BAM index) writer/reader, from scratch (port of ``dorado_tpu/io/bai.py``).


The reference writes a ``.bai`` next to every sorted BAM it emits
(dorado/hts_utils/hts_file.cpp:446-509 — ``sam_idx_init``/``sam_idx_save``
during the final merge; extension from hts_file.cpp:133-142). Downstream
tools (samtools view -X, IGV, variant callers) expect it, so the sorted
writer here produces one too.

Format (SAM spec §5.2, matching htslib's writer):

- magic ``BAI\\1``, ``n_ref``
- per reference: ``n_bin`` × (bin id, chunk list of virtual-offset pairs),
  then the 16 kb linear index of minimal virtual offsets
- pseudo-bin 37450 per reference carries [unmapped_beg, unmapped_end] +
  (mapped, unmapped) counts — htslib's metadata chunk
- trailing ``n_no_coor`` count of coordinate-less records

Virtual offsets are ``coffset << 16 | uoffset`` over the BGZF stream; the
BgzfWriter exposes them via ``virtual_offset()``.
"""

from __future__ import annotations

import re
import struct
from typing import BinaryIO

_CIGAR_REF_OPS = frozenset("MDN=X")
_BIN_LIMIT = 37450  # metadata pseudo-bin id
_MAX_POS = 1 << 29  # BAI addresses at most 512 Mbp per reference


def reg2bin(beg: int, end: int) -> int:
    """SAM spec reg2bin over the 0-based half-open interval [beg, end)."""
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


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins that may contain records overlapping [beg, end). Inputs are
    clamped to the 512 Mbp BAI address space like htslib, so an 'until end
    of contig' sentinel never reaches the metadata pseudo-bin id range."""
    beg = max(0, min(beg, _MAX_POS - 1))
    end = max(beg + 1, min(end, _MAX_POS))
    end -= 1
    bins = [0]
    for shift, offset in (
        (26, 1),
        (23, 9),
        (20, 73),
        (17, 585),
        (14, 4681),
    ):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def cigar_ref_span(cigar: str) -> int:
    """Reference bases consumed by a CIGAR string (M/D/N/=/X ops)."""
    if not cigar or cigar == "*":
        return 1
    span = 0
    for num, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        if op in _CIGAR_REF_OPS:
            span += int(num)
    return max(span, 1)


class BaiBuilder:
    """Accumulates (tid, beg, end, voffset range) per written record and
    serialises the index. Records must arrive in coordinate order (the
    sorted writer guarantees it)."""

    def __init__(self, n_ref: int):
        self.n_ref = n_ref
        # per ref: {bin: [ [beg_voff, end_voff], ... ]}
        self._bins: list[dict[int, list[list[int]]]] = [dict() for _ in range(n_ref)]
        self._linear: list[dict[int, int]] = [dict() for _ in range(n_ref)]
        self._mapped = [0] * n_ref
        self._unmapped = [0] * n_ref
        self._off_span = [[None, None] for _ in range(n_ref)]  # voffset extent
        self.n_no_coor = 0

    def add(self, tid: int, beg: int, end: int, v0: int, v1: int, mapped: bool) -> None:
        if tid < 0 or beg < 0:
            self.n_no_coor += 1
            return
        end = min(max(end, beg + 1), _MAX_POS)
        beg = min(beg, _MAX_POS - 1)
        if mapped:
            self._mapped[tid] += 1
        else:
            self._unmapped[tid] += 1
        b = reg2bin(beg, end)
        chunks = self._bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == v0:
            chunks[-1][1] = v1  # merge adjacent chunks like htslib
        else:
            chunks.append([v0, v1])
        lin = self._linear[tid]
        for i in range(beg >> 14, ((end - 1) >> 14) + 1):
            if i not in lin or v0 < lin[i]:
                lin[i] = v0
        span = self._off_span[tid]
        if span[0] is None or v0 < span[0]:
            span[0] = v0
        if span[1] is None or v1 > span[1]:
            span[1] = v1

    def write(self, fh: BinaryIO) -> None:
        out = [b"BAI\x01", struct.pack("<i", self.n_ref)]
        for tid in range(self.n_ref):
            bins = self._bins[tid]
            has_meta = self._mapped[tid] or self._unmapped[tid]
            out.append(struct.pack("<i", len(bins) + (1 if has_meta else 0)))
            for b in sorted(bins):
                chunks = bins[b]
                out.append(struct.pack("<Ii", b, len(chunks)))
                for beg, end in chunks:
                    out.append(struct.pack("<QQ", beg, end))
            if has_meta:
                span = self._off_span[tid]
                out.append(struct.pack("<Ii", _BIN_LIMIT, 2))
                out.append(struct.pack("<QQ", span[0] or 0, span[1] or 0))
                out.append(
                    struct.pack("<QQ", self._mapped[tid], self._unmapped[tid])
                )
            lin = self._linear[tid]
            n_intv = (max(lin) + 1) if lin else 0
            out.append(struct.pack("<i", n_intv))
            prev = 0
            for i in range(n_intv):
                # windows with no record starts inherit the previous offset
                if i in lin:
                    prev = lin[i]
                out.append(struct.pack("<Q", prev))
        out.append(struct.pack("<Q", self.n_no_coor))
        fh.write(b"".join(out))


def read_bai(fh: BinaryIO):
    """Parse a .bai into ({tid: {bin: [(beg, end), ...]}}, {tid: [ioffsets]},
    n_no_coor) — used by region queries and the round-trip tests."""
    data = fh.read()
    if data[:4] != b"BAI\x01":
        raise ValueError("not a BAI file")
    off = 4
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    bins_by_tid: dict[int, dict[int, list[tuple[int, int]]]] = {}
    linear_by_tid: dict[int, list[int]] = {}
    for tid in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins: dict[int, list[tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                beg, end = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((beg, end))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        ioff = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        bins_by_tid[tid] = bins
        linear_by_tid[tid] = ioff
    n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
    return bins_by_tid, linear_by_tid, n_no_coor


def query_chunks(bins: dict[int, list[tuple[int, int]]], linear: list[int],
                 beg: int, end: int) -> list[tuple[int, int]]:
    """Candidate voffset chunks for records overlapping [beg, end)."""
    beg = max(0, min(beg, _MAX_POS - 1))
    end = max(beg + 1, min(end, _MAX_POS))
    min_off = 0
    w = beg >> 14
    if linear and w < len(linear):
        min_off = linear[w]
    out = []
    for b in reg2bins(beg, end):
        if b >= _BIN_LIMIT:  # metadata pseudo-bin carries counts, not chunks
            continue
        for c0, c1 in bins.get(b, ()):
            if c1 > min_off:
                out.append((max(c0, min_off), c1))
    out.sort()
    return out
