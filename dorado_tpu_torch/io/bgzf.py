"""BGZF block-compressed writer and reader (the container format of BAM).

Pure-python implementation over zlib raw-deflate: 64 KiB-max blocks, each a
complete gzip member carrying a BC extra field with the compressed block size,
terminated by the canonical 28-byte EOF block. Mirrors htslib bgzf semantics.
"""

from __future__ import annotations

import struct
import zlib
from collections import deque
from typing import BinaryIO, Iterator

# Canonical BGZF EOF marker block (htslib bgzf.c).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_MAX_BLOCK = 0xFF00  # 65280: htslib's max uncompressed payload per block


def _compress_member(payload: bytes, level: int) -> bytes:
    """One complete BGZF gzip member for ``payload``. Pure function so it
    can run on a worker thread (zlib releases the GIL)."""
    compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = compressor.compress(payload) + compressor.flush()
    bsize = len(cdata) + 26  # header(18) + footer(8)
    header = (
        b"\x1f\x8b\x08\x04"
        + struct.pack("<I", 0)
        + b"\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    return header + cdata + footer


class BgzfWriter:
    """``threads > 1`` compresses full blocks on a thread pool and writes
    the members in submission order — htslib's ``bgzf_mt`` analogue, with
    byte-identical output (each 64 KiB block is an independent gzip member,
    and zlib output is deterministic for a given level). ``virtual_offset``
    waits for the blocks in flight: a writer that asks for it per record
    (BAI building) runs without threads."""

    def __init__(self, fileobj: BinaryIO, level: int = 6, threads: int = 0):
        self._fh = fileobj
        self._level = level
        self._buffer = bytearray()
        self._coffset = 0  # compressed bytes emitted so far
        self._pool = None
        self._pending: deque = deque()
        if threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=threads)
            self._high_water = threads * 4

    def virtual_offset(self) -> int:
        """BGZF virtual offset (coffset << 16 | uoffset) of the next byte
        written — the coordinate BAI indexing addresses records by."""
        if self._pending:
            self._drain(wait_all=True)
        return (self._coffset << 16) | len(self._buffer)

    def write(self, data: bytes) -> None:
        self._buffer += data
        while len(self._buffer) >= _MAX_BLOCK:
            payload = bytes(self._buffer[:_MAX_BLOCK])
            del self._buffer[:_MAX_BLOCK]
            if self._pool is not None:
                self._pending.append(
                    self._pool.submit(_compress_member, payload, self._level)
                )
                self._drain()
            else:
                self._write_member(_compress_member(payload, self._level))

    def _write_member(self, member: bytes) -> None:
        self._fh.write(member)
        self._coffset += len(member)

    def _drain(self, wait_all: bool = False) -> None:
        # emit completed members in order; block only above the high-water
        # mark (bounds memory at ~high_water * 64 KiB)
        while self._pending:
            head = self._pending[0]
            if wait_all or len(self._pending) > self._high_water or head.done():
                self._write_member(self._pending.popleft().result())
            else:
                break

    def flush(self) -> None:
        """Force the buffered payload out as a block, so the next write
        starts on a BGZF block boundary (used after the BAM header)."""
        if self._pending:
            self._drain(wait_all=True)
        if self._buffer:
            self._write_member(_compress_member(bytes(self._buffer), self._level))
            self._buffer.clear()

    def close(self) -> None:
        self.flush()
        self._fh.write(BGZF_EOF)
        self._fh.flush()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_member(fh: BinaryIO) -> tuple[bytes, int] | None:
    """(decompressed payload, compressed size) of the BGZF member at ``fh``'s
    position, or None at the end of the file."""
    hdr = fh.read(12)
    if not hdr:
        return None
    if len(hdr) < 12 or hdr[:2] != b"\x1f\x8b":
        raise ValueError("bad BGZF magic")
    xlen = struct.unpack_from("<H", hdr, 10)[0]
    extra = fh.read(xlen)
    bsize = None
    epos = 0
    while epos < len(extra):
        slen = struct.unpack_from("<H", extra, epos + 2)[0]
        if extra[epos : epos + 2] == b"BC":
            bsize = struct.unpack_from("<H", extra, epos + 4)[0] + 1
        epos += 4 + slen
    if bsize is None:
        raise ValueError("missing BGZF BC field")
    cdata = fh.read(bsize - 12 - xlen)[:-8]
    return (zlib.decompress(cdata, -15) if cdata else b""), bsize


def iter_members(fh: BinaryIO) -> Iterator[bytes]:
    """The decompressed payload of each BGZF member of ``fh``, one at a time."""
    while (member := _read_member(fh)) is not None:
        if member[0]:
            yield member[0]


class BgzfReader:
    """``read(n)`` over the concatenated payloads of a BGZF stream, holding
    one member (at most 64 KiB) at a time."""

    def __init__(self, fileobj: BinaryIO):
        self._members = iter_members(fileobj)
        self._buf = b""
        self._off = 0

    def read(self, n: int) -> bytes:
        parts = []
        while n:
            avail = len(self._buf) - self._off
            if avail == 0:
                self._buf = next(self._members, None)
                self._off = 0
                if self._buf is None:
                    self._buf = b""
                    break
                continue
            take = min(avail, n)
            parts.append(self._buf[self._off : self._off + take])
            self._off += take
            n -= take
        return b"".join(parts)


class BgzfRandomReader:
    """A seekable BGZF reader addressed by virtual offsets (coffset << 16 |
    uoffset): the read side of the .bai index (``io/bai.py``)."""

    def __init__(self, fileobj: BinaryIO):
        self._fh = fileobj
        self._payload = b""
        self._coffset = 0  # file offset of the loaded member
        self._next_coffset = 0
        self._off = 0

    def _load(self, coffset: int) -> bool:
        self._fh.seek(coffset)
        try:
            member = _read_member(self._fh)
        except ValueError:
            return False
        if member is None:
            return False
        self._payload, bsize = member
        self._coffset = coffset
        self._next_coffset = coffset + bsize
        self._off = 0
        return bool(self._payload)

    def seek_voffset(self, v: int) -> bool:
        if not self._load(v >> 16):
            return False
        self._off = v & 0xFFFF
        return self._off <= len(self._payload)

    def voffset(self) -> int:
        if self._off >= len(self._payload):
            return self._next_coffset << 16
        return (self._coffset << 16) | self._off

    def read(self, n: int) -> bytes:
        parts = []
        while n:
            avail = len(self._payload) - self._off
            if avail == 0:
                if not self._load(self._next_coffset):
                    break
                continue
            take = min(avail, n)
            parts.append(self._payload[self._off : self._off + take])
            self._off += take
            n -= take
        return b"".join(parts)
