"""rANS codecs used by CRAM: rANS 4x8 (CRAM 3.0) and rANS Nx16 (CRAM 3.1).

Port of ``dorado_tpu/io/rans.py``: the formats defined in the hts-specs
CRAMcodecs document and produced by htslib/htscodecs (the reference links
htslib for all CRAM IO, dorado/hts_utils/hts_file.cpp), with the same bytes
out as the JAX package's coders wherever those write any (a frequency table
whose rare symbols, each raised to 1, outgrow the floors makes the JAX
encoders raise; here it is normalised). Host code: numpy and one Python step
a byte; the decoders read htslib's layouts, the encoders are the round-trip
partners of the CRAM writer.

rANS core: the asymmetric numeral system "range" variant with interleaved
decoder states. 4x8 = 4 states, 8-bit renormalisation, 12-bit frequencies,
state floor 1<<23. Nx16 = 4 or 32 states, 16-bit renormalisation, state
floor 1<<15, 12-bit frequencies (order-0) and 12- or 10-bit (order-1), plus
bit-pack / run-length / striping / cat pre-transforms.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


class _Reader:
    __slots__ = ("d", "p")

    def __init__(self, d: bytes, p: int = 0):
        self.d = d
        self.p = p

    def u8(self) -> int:
        v = self.d[self.p]
        self.p += 1
        return v

    def take(self, n: int) -> bytes:
        v = self.d[self.p : self.p + n]
        if len(v) != n:
            raise ValueError("rANS stream truncated")
        self.p += n
        return v

    def u32le(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u7(self) -> int:
        """htscodecs var_get_u32: big-endian 7-bit groups, high bit = more."""
        v = 0
        while True:
            b = self.u8()
            v = (v << 7) | (b & 0x7F)
            if not (b & 0x80):
                return v


def _put_u7(v: int) -> bytes:
    out = bytearray()
    while True:
        out.append(v & 0x7F)
        v >>= 7
        if not v:
            break
    out.reverse()
    for i in range(len(out) - 1):
        out[i] |= 0x80
    return bytes(out)


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0)
# ---------------------------------------------------------------------------

_TF12 = 1 << 12
_L4x8 = 1 << 23


def _read_freq_4x8(r: _Reader) -> int:
    b = r.u8()
    if b >= 128:
        return ((b & 0x7F) << 8) | r.u8()
    return b


def _write_freq_4x8(f: int) -> bytes:
    if f < 128:
        return bytes([f])
    return bytes([0x80 | (f >> 8), f & 0xFF])


def _read_table_4x8(r: _Reader) -> np.ndarray:
    """Symbol/frequency table with the spec's ascending-symbol RLE."""
    F = np.zeros(256, dtype=np.uint32)
    j = r.u8()
    rle = 0
    while True:
        F[j] = _read_freq_4x8(r)
        if rle > 0:
            rle -= 1
            j += 1
        else:
            nxt = r.u8()
            if nxt == (j + 1) & 0xFF and nxt != 0:
                # peeked run start: the count byte follows
                j = nxt
                rle = r.u8()
            else:
                j = nxt
        if j == 0:
            break
    return F


def _write_table_4x8(F: np.ndarray) -> bytes:
    syms = np.nonzero(F)[0]
    out = bytearray()
    rle = 0
    for k, s in enumerate(syms):
        if rle > 0:
            rle -= 1
        else:
            out.append(int(s))
            if k and s == syms[k - 1] + 1:
                # start of a run: count the consecutive tail
                run = 0
                while k + run + 1 < len(syms) and syms[k + run + 1] == s + run + 1:
                    run += 1
                out.append(run)
                rle = run
        out += _write_freq_4x8(int(F[s]))
    out.append(0)
    return bytes(out)


def _dtable(F: np.ndarray, bits: int):
    """cum[s], and slot->symbol lookup of size 1<<bits."""
    cum = np.zeros(257, dtype=np.uint32)
    np.cumsum(F, out=cum[1:])
    if cum[-1] > (1 << bits):
        raise ValueError("rANS frequency table overflows")
    lookup = np.zeros(1 << bits, dtype=np.uint8)
    for s in np.nonzero(F)[0]:
        lookup[cum[s] : cum[s + 1]] = s
    return cum, lookup


def _normalize_freqs(counts: np.ndarray, total: int) -> np.ndarray:
    """Scale counts to sum exactly `total`, keeping nonzero counts nonzero."""
    F = counts.astype(np.float64)
    n = F.sum()
    if n == 0:
        return np.zeros(256, dtype=np.uint32)
    out = np.floor(F * total / n).astype(np.int64)
    out[(counts > 0) & (out == 0)] = 1
    # fix rounding drift on the largest symbol; the drift is negative where
    # the rare symbols raised to 1 outweigh the floors (the JAX package's
    # unsigned table overflows there and writes nothing)
    diff = total - int(out.sum())
    out[int(np.argmax(out))] += diff
    if out[int(np.argmax(out))] <= 0:
        raise ValueError("cannot normalise frequencies")
    return out.astype(np.uint32)


def rans4x8_decode(data: bytes) -> bytes:
    r = _Reader(data)
    order = r.u8()
    comp_size = r.u32le()
    out_size = r.u32le()
    if order & 1:
        return _rans4x8_decode_o1(r, out_size)
    return _rans4x8_decode_o0(r, out_size)


def _renorm8(r: _Reader, x: int) -> int:
    while x < _L4x8:
        x = ((x << 8) | r.u8()) & 0xFFFFFFFF
    return x


def _rans4x8_decode_o0(r: _Reader, out_size: int) -> bytes:
    F = _read_table_4x8(r)
    cum, lookup = _dtable(F, 12)
    R = [r.u32le() for _ in range(4)]
    out = bytearray(out_size)
    for i in range(out_size):
        j = i & 3
        x = R[j]
        m = x & (_TF12 - 1)
        s = lookup[m]
        out[i] = s
        x = int(F[s]) * (x >> 12) + m - int(cum[s])
        R[j] = _renorm8(r, x)
    return bytes(out)


def _rans4x8_decode_o1(r: _Reader, out_size: int) -> bytes:
    Fs: dict[int, tuple] = {}
    i = r.u8()
    rle_i = 0
    while True:
        F = _read_table_4x8(r)
        Fs[i] = (F, *_dtable(F, 12))
        if rle_i > 0:
            rle_i -= 1
            i += 1
        else:
            nxt = r.u8()
            if nxt == (i + 1) & 0xFF and nxt != 0:
                i = nxt
                rle_i = r.u8()
            else:
                i = nxt
        if i == 0:
            break
    R = [r.u32le() for _ in range(4)]
    out = bytearray(out_size)
    isz4 = out_size >> 2
    ptr = [0, isz4, 2 * isz4, 3 * isz4]
    ctx = [0, 0, 0, 0]
    for _ in range(isz4):
        for j in range(4):
            x = R[j]
            F, cum, lookup = Fs.get(ctx[j]) or _EMPTY_O1
            m = x & (_TF12 - 1)
            s = lookup[m]
            out[ptr[j]] = s
            ptr[j] += 1
            x = int(F[s]) * (x >> 12) + m - int(cum[s])
            R[j] = _renorm8(r, x)
            ctx[j] = s
    # remainder handled by state 3
    for pos in range(4 * isz4, out_size):
        x = R[3]
        F, cum, lookup = Fs.get(ctx[3]) or _EMPTY_O1
        m = x & (_TF12 - 1)
        s = lookup[m]
        out[pos] = s
        x = int(F[s]) * (x >> 12) + m - int(cum[s])
        R[3] = _renorm8(r, x)
        ctx[3] = s
    return bytes(out)


_EMPTY_O1 = (
    np.zeros(256, dtype=np.uint32),
    np.zeros(257, dtype=np.uint32),
    np.zeros(_TF12, dtype=np.uint8),
)


def rans4x8_encode(data: bytes, order: int = 0) -> bytes:
    if order & 1:
        body = _rans4x8_encode_o1(data)
    else:
        body = _rans4x8_encode_o0(data)
    return bytes([order]) + len(body).to_bytes(4, "little") + len(data).to_bytes(
        4, "little"
    ) + body


def _enc_put(x: int, F: int, cum: int, bits: int, out: bytearray) -> int:
    """Encoder step (emits renorm bytes to `out`, which is built reversed)."""
    x_max = ((_L4x8 >> bits) << 8) * F
    while x >= x_max:
        out.append(x & 0xFF)
        x >>= 8
    return ((x // F) << bits) + (x % F) + cum


def _rans4x8_encode_o0(data: bytes) -> bytes:
    counts = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    if len(data) == 0:
        return _write_table_4x8(np.zeros(256, dtype=np.uint32)) + b"\x00" * 16
    F = _normalize_freqs(counts, _TF12)
    cum = np.zeros(257, dtype=np.uint64)
    np.cumsum(F, out=cum[1:])
    hdr = _write_table_4x8(F)
    R = [_L4x8] * 4
    rev = bytearray()
    for i in range(len(data) - 1, -1, -1):
        j = i & 3
        s = data[i]
        R[j] = _enc_put(R[j], int(F[s]), int(cum[s]), 12, rev)
    tail = bytearray()
    for j in range(4):
        tail += int(R[j]).to_bytes(4, "little")
    return bytes(hdr) + bytes(tail) + bytes(reversed(rev))


def _rans4x8_encode_o1(data: bytes) -> bytes:
    n = len(data)
    isz4 = n >> 2
    # gather order-1 stats along the 4 decode streams
    counts = np.zeros((256, 256), dtype=np.int64)
    arr = np.frombuffer(data, np.uint8)
    for j in range(4):
        seg = arr[j * isz4 : (j + 1) * isz4] if j < 3 else arr[3 * isz4 :]
        if len(seg):
            counts[0, seg[0]] += 1
            np.add.at(counts, (seg[:-1], seg[1:]), 1)
    Fs = {}
    hdr = bytearray()
    used = np.nonzero(counts.sum(axis=1))[0]
    prev = None
    run_left = 0
    for k, i in enumerate(used):
        F = _normalize_freqs(counts[i], _TF12)
        cum = np.zeros(257, dtype=np.uint64)
        np.cumsum(F, out=cum[1:])
        Fs[int(i)] = (F, cum)
        if run_left > 0:
            run_left -= 1
        else:
            hdr.append(int(i))
            if k and i == used[k - 1] + 1:
                run = 0
                while k + run + 1 < len(used) and used[k + run + 1] == i + run + 1:
                    run += 1
                hdr.append(run)
                run_left = run
        hdr += _write_table_4x8(F)
        prev = i
    hdr.append(0)
    # encode the 4 streams backwards
    R = [_L4x8] * 4
    rev = bytearray()
    # stream 3 includes the tail; encode positions in reverse global order of
    # the decoder's emission: decoder interleaves quarter-streams, tail last.
    # Encoding backwards per stream is sufficient because renorm bytes from
    # different states interleave in consumption order = reverse emission.
    # Build (state, ctx_pos, pos) emission order then reverse it.
    emission = []
    ptr = [0, isz4, 2 * isz4, 3 * isz4]
    for _ in range(isz4):
        for j in range(4):
            emission.append((j, ptr[j]))
            ptr[j] += 1
    for pos in range(4 * isz4, n):
        emission.append((3, pos))
    starts = {0: 0, 1: isz4, 2: 2 * isz4, 3: 3 * isz4}
    for j, pos in reversed(emission):
        s = data[pos]
        ctx = data[pos - 1] if pos != starts[j] else 0
        F, cum = Fs.get(ctx) or (None, None)
        R[j] = _enc_put(R[j], int(F[s]), int(cum[s]), 12, rev)
    tail = bytearray()
    for j in range(4):
        tail += int(R[j]).to_bytes(4, "little")
    return bytes(hdr) + bytes(tail) + bytes(reversed(rev))


# ---------------------------------------------------------------------------
# rANS Nx16 (CRAM 3.1)
# ---------------------------------------------------------------------------

ORDER_O1 = 0x01
ORDER_X32 = 0x04
ORDER_STRIPE = 0x08
ORDER_NOSZ = 0x10
ORDER_CAT = 0x20
ORDER_RLE = 0x40
ORDER_PACK = 0x80

_LN16 = 1 << 15


def _renorm16(r: _Reader, x: int) -> int:
    if x < _LN16:
        x = (x << 16) | int.from_bytes(r.take(2), "little")
    return x


def _read_alphabet(r: _Reader) -> list[int]:
    syms = []
    rle = 0
    s = r.u8()
    last = s
    while True:
        syms.append(s)
        if rle > 0:
            rle -= 1
            s += 1
        else:
            s = r.u8()
            # no 8-bit wrap: last=255 never chains into the 0 terminator
            if s == last + 1:
                rle = r.u8()
        last = s
        if s == 0:
            break
    return syms


def _write_alphabet(syms: list[int]) -> bytes:
    out = bytearray()
    rle = 0
    for k, s in enumerate(syms):
        if rle > 0:
            rle -= 1
            continue
        out.append(s)
        if k and s == syms[k - 1] + 1:
            run = 0
            while k + run + 1 < len(syms) and syms[k + run + 1] == s + run + 1:
                run += 1
            out.append(run)
            rle = run
    out.append(0)
    return bytes(out)


def _read_freqs_o0_nx16(r: _Reader) -> np.ndarray:
    """Alphabet + u7 freqs, stored normalised to a power of two <= 4096 and
    scaled up to 4096 here."""
    syms = _read_alphabet(r)
    F = np.zeros(256, dtype=np.uint32)
    total = 0
    for s in syms:
        f = r.u7()
        F[s] = f
        total += f
    if total == 0:
        raise ValueError("rANS Nx16: empty frequency table")
    # scale to 4096
    shift = 0
    while (total << shift) < _TF12:
        shift += 1
    if (total << shift) != _TF12:
        raise ValueError("rANS Nx16: frequencies not a power-of-two total")
    if shift:
        F <<= shift
    return F


def _write_freqs_o0_nx16(F: np.ndarray) -> bytes:
    syms = [int(s) for s in np.nonzero(F)[0]]
    out = bytearray(_write_alphabet(syms))
    for s in syms:
        out += _put_u7(int(F[s]))
    return bytes(out)


def _nx16_decode_o0(r: _Reader, out_size: int, N: int) -> bytes:
    F = _read_freqs_o0_nx16(r)
    cum, lookup = _dtable(F, 12)
    R = [r.u32le() for _ in range(N)]
    out = bytearray(out_size)
    for i in range(out_size):
        j = i % N
        x = R[j]
        m = x & (_TF12 - 1)
        s = lookup[m]
        out[i] = s
        x = int(F[s]) * (x >> 12) + m - int(cum[s])
        R[j] = _renorm16(r, x)
    return bytes(out)


def _read_freqs_o1_nx16(r: _Reader):
    """Order-1 table: flag byte (bit0 = table itself rANS-O0-compressed,
    bits4+ = frequency bit width), then per-context alphabet'd tables."""
    flags = r.u8()
    shift = flags >> 4
    if flags & 1:
        u_sz = r.u7()
        c_sz = r.u7()
        sub = _Reader(r.take(c_sz))
        table = _nx16_decode_o0(sub, u_sz, 4)
        r2 = _Reader(table)
    else:
        r2 = r
    syms = _read_alphabet(r2)
    tot = 1 << shift
    Fs = {}
    for i in syms:
        F = np.zeros(256, dtype=np.uint32)
        total = 0
        run = 0
        for j in syms:
            if run > 0:
                run -= 1
                continue
            f = r2.u7()
            F[j] = f
            total += f
            if f == 0:
                run = r2.u8()
        if total and total != tot:
            s2 = 0
            while (total << s2) < tot:
                s2 += 1
            if (total << s2) != tot:
                raise ValueError("rANS Nx16 O1: bad frequency total")
            F <<= s2
        Fs[i] = (F, *_dtable(F, shift))
    return Fs, shift


def _nx16_decode_o1(r: _Reader, out_size: int, N: int) -> bytes:
    Fs, shift = _read_freqs_o1_nx16(r)
    mask = (1 << shift) - 1
    R = [r.u32le() for _ in range(N)]
    out = bytearray(out_size)
    iszN = out_size // N
    ptr = [j * iszN for j in range(N)]
    ctx = [0] * N
    empty = _EMPTY_O1
    for _ in range(iszN):
        for j in range(N):
            x = R[j]
            F, cum, lookup = Fs.get(ctx[j], empty)
            m = x & mask
            s = lookup[m]
            out[ptr[j]] = s
            ptr[j] += 1
            x = int(F[s]) * (x >> shift) + m - int(cum[s])
            R[j] = _renorm16(r, x)
            ctx[j] = s
    for pos in range(N * iszN, out_size):
        x = R[N - 1]
        F, cum, lookup = Fs.get(ctx[N - 1], empty)
        m = x & mask
        s = lookup[m]
        out[pos] = s
        x = int(F[s]) * (x >> shift) + m - int(cum[s])
        R[N - 1] = _renorm16(r, x)
        ctx[N - 1] = s
    return bytes(out)


def _unpack(packed: bytes, mapping: bytes, out_size: int) -> bytes:
    n = len(mapping)
    p = np.frombuffer(packed, np.uint8)
    if n <= 1:
        return bytes([mapping[0]]) * out_size if n else b""
    if n <= 2:
        idx = (p[np.arange(out_size) >> 3] >> (np.arange(out_size) & 7)) & 1
    elif n <= 4:
        i = np.arange(out_size)
        idx = (p[i >> 2] >> ((i & 3) * 2)) & 3
    elif n <= 16:
        i = np.arange(out_size)
        idx = (p[i >> 1] >> ((i & 1) * 4)) & 15
    else:
        raise ValueError("rANS Nx16 PACK: >16 symbols")
    m = np.frombuffer(mapping, np.uint8)
    return m[idx].tobytes()


def _pack(data: bytes) -> tuple[bytes, bytes]:
    """Returns (mapping, packed)."""
    arr = np.frombuffer(data, np.uint8)
    syms = np.unique(arr)
    n = len(syms)
    if n > 16:
        raise ValueError("too many symbols to pack")
    inv = np.zeros(256, dtype=np.uint8)
    inv[syms] = np.arange(n)
    idx = inv[arr]
    if n <= 1:
        packed = b""
    elif n <= 2:
        pad = (-len(idx)) % 8
        bits = np.concatenate([idx, np.zeros(pad, np.uint8)]).reshape(-1, 8)
        packed = (bits << np.arange(8)).sum(axis=1).astype(np.uint8).tobytes()
    elif n <= 4:
        pad = (-len(idx)) % 4
        q = np.concatenate([idx, np.zeros(pad, np.uint8)]).reshape(-1, 4)
        packed = (q << (np.arange(4) * 2)).sum(axis=1).astype(np.uint8).tobytes()
    else:
        pad = (-len(idx)) % 2
        q = np.concatenate([idx, np.zeros(pad, np.uint8)]).reshape(-1, 2)
        packed = (q << (np.arange(2) * 4)).sum(axis=1).astype(np.uint8).tobytes()
    return syms.tobytes(), packed


def _rle_decode(lits: bytes, meta: bytes, out_size: int) -> bytes:
    mr = _Reader(meta)
    nsyms = mr.u8()
    if nsyms == 0:
        nsyms = 256
    in_set = bytearray(256)
    for _ in range(nsyms):
        in_set[mr.u8()] = 1
    out = bytearray(out_size)
    pos = 0
    for b in lits:
        if in_set[b]:
            run = mr.u7()
            end = pos + run + 1
            out[pos:end] = bytes([b]) * (run + 1)
            pos = end
        else:
            out[pos] = b
            pos += 1
    if pos != out_size:
        raise ValueError("rANS Nx16 RLE: output size mismatch")
    return bytes(out)


def _rle_encode(data: bytes) -> tuple[bytes, bytes]:
    """Returns (meta, literals). RLE-encodes every symbol that appears in a
    run of >= 4 anywhere (simple heuristic)."""
    arr = np.frombuffer(data, np.uint8)
    # find runs
    if len(arr) == 0:
        return bytes([1, 0]), b""
    change = np.nonzero(np.diff(arr))[0] + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [len(arr)]]))
    rle_syms = sorted(set(int(arr[s]) for s, ln in zip(starts, lens) if ln >= 4))
    if not rle_syms:
        rle_syms = [int(arr[0])]
    meta = bytearray([len(rle_syms) & 0xFF])
    meta += bytes(rle_syms)
    in_set = set(rle_syms)
    lits = bytearray()
    for s, ln in zip(starts, lens):
        b = int(arr[s])
        if b in in_set:
            lits.append(b)
            meta += _put_u7(int(ln) - 1)
        else:
            lits += bytes([b]) * int(ln)
    return bytes(meta), bytes(lits)


def ransNx16_decode(data: bytes, out_size: int | None = None) -> bytes:
    r = _Reader(data)
    flags = r.u8()
    N = 32 if flags & ORDER_X32 else 4
    if flags & ORDER_STRIPE:
        if not (flags & ORDER_NOSZ):
            out_size = r.u7()
        n_streams = r.u8()
        clens = [r.u7() for _ in range(n_streams)]
        subs = []
        for j in range(n_streams):
            ulen = out_size // n_streams + (1 if j < out_size % n_streams else 0)
            subs.append(ransNx16_decode(r.take(clens[j]), ulen))
        out = bytearray(out_size)
        for j, sub in enumerate(subs):
            out[j::n_streams] = sub
        return bytes(out)
    if not (flags & ORDER_NOSZ):
        out_size = r.u7()
    if out_size is None:
        raise ValueError("rANS Nx16: NOSZ stream needs an explicit size")

    final_size = out_size
    pack_map = None
    if flags & ORDER_PACK:
        nsym = r.u8()
        pack_map = r.take(nsym)
        out_size = r.u7()  # size before unpacking

    rle_meta = None
    rle_out_size = out_size
    if flags & ORDER_RLE:
        rmeta_len = r.u7()
        out_size = r.u7()  # literal stream length (pre-RLE-expansion)
        if rmeta_len & 1:
            rle_meta = r.take(rmeta_len >> 1)
        else:
            c_len = r.u7()
            rle_meta = _nx16_decode_o0(_Reader(r.take(c_len)), rmeta_len >> 1, 4)

    if flags & ORDER_CAT:
        data_out = r.take(out_size)
    elif flags & ORDER_O1:
        data_out = _nx16_decode_o1(r, out_size, N)
    else:
        data_out = _nx16_decode_o0(r, out_size, N)

    if flags & ORDER_RLE:
        data_out = _rle_decode(data_out, rle_meta, rle_out_size)
    if flags & ORDER_PACK:
        data_out = _unpack(data_out, pack_map, final_size)
    if len(data_out) != final_size:
        raise ValueError("rANS Nx16: output size mismatch")
    return data_out


def _nx16_encode_o0(data: bytes) -> bytes:
    counts = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    F = _normalize_freqs(counts, _TF12)
    cum = np.zeros(257, dtype=np.uint64)
    np.cumsum(F, out=cum[1:])
    hdr = _write_freqs_o0_nx16(F)
    R = [_LN16] * 4
    rev = bytearray()
    for i in range(len(data) - 1, -1, -1):
        j = i & 3
        s = data[i]
        f = int(F[s])
        x = R[j]
        x_max = ((_LN16 >> 12) << 16) * f
        if x >= x_max:
            rev += int(x & 0xFFFF).to_bytes(2, "little")[::-1]
            x >>= 16
        R[j] = ((x // f) << 12) + (x % f) + int(cum[s])
    tail = bytearray()
    for j in range(4):
        tail += int(R[j]).to_bytes(4, "little")
    return bytes(hdr) + bytes(tail) + bytes(reversed(rev))


def ransNx16_encode(data: bytes, flags: int = 0) -> bytes:
    """Encoder supporting O0 (optionally CAT for incompressible data)."""
    out = bytearray()
    if len(data) == 0 or len(np.unique(np.frombuffer(data, np.uint8))) < 2:
        # degenerate: CAT tiny streams / single-symbol via PACK
        if len(data) and len(set(data)) == 1:
            out.append(ORDER_PACK | ORDER_CAT)
            out += _put_u7(len(data))
            out.append(1)
            out.append(data[0])
            out += _put_u7(0)
            return bytes(out)
        out.append(ORDER_CAT)
        out += _put_u7(len(data))
        out += data
        return bytes(out)
    out.append(0)  # order-0, 4-way
    out += _put_u7(len(data))
    out += _nx16_encode_o0(data)
    return bytes(out)
