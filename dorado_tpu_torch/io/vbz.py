"""VBZ signal codec (zstd + svb16 stream-variable-byte, zigzag delta).

Port of ``dorado_tpu/io/vbz.py``. POD5 stores raw int16 signal compressed
with VBZ: values are delta-encoded, zigzag-mapped to unsigned, packed svb16
(one control bit per value selecting a 1- or 2-byte encoding), and the
result zstd-compressed. svb16 is vectorised numpy here; zstd goes through a
small ``ctypes`` binding to the system's ``libzstd.so.1``, loaded at first
use. Without that library the codec raises, naming it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

import numpy as np

_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2
_ZSTD_LEVEL = 1  # the compression level of the reference's VBZ writer

_lock = threading.Lock()
_zstd: ctypes.CDLL | None = None


def _libzstd() -> ctypes.CDLL:
    """The system zstd library, bound at first use."""
    global _zstd
    with _lock:
        if _zstd is None:
            name = ctypes.util.find_library("zstd") or "libzstd.so.1"
            try:
                lib = ctypes.CDLL(name)
            except OSError as exc:
                raise RuntimeError(
                    f"VBZ signal needs the zstd library (libzstd.so.1), which could not be "
                    f"loaded: {exc}"
                ) from exc
            size_t, vp = ctypes.c_size_t, ctypes.c_void_p
            for fn, res, args in (
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
                ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int]),
                ("ZSTD_compressBound", size_t, [size_t]),
                ("ZSTD_isError", ctypes.c_uint, [size_t]),
                ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                ("ZSTD_versionString", ctypes.c_char_p, []),
            ):
                f = getattr(lib, fn)
                f.restype, f.argtypes = res, args
            lib.dtt_name = name
            _zstd = lib
        return _zstd


def libzstd_version() -> str:
    """Which zstd library the codec loaded, and its version."""
    lib = _libzstd()
    return f"{lib.dtt_name} (zstd {lib.ZSTD_versionString().decode()})"


def _check(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"corrupt VBZ: zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(blob: bytes, max_output_size: int) -> bytes:
    """One zstd frame -> its content, which may be at most
    ``max_output_size`` bytes."""
    lib = _libzstd()
    size = lib.ZSTD_getFrameContentSize(blob, len(blob))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise ValueError("corrupt VBZ: not a zstd frame")
    if size == _ZSTD_CONTENTSIZE_UNKNOWN:
        size = max_output_size
    elif size > max_output_size:
        raise ValueError(f"corrupt VBZ: zstd frame of {size} bytes, at most "
                         f"{max_output_size} expected")
    out = ctypes.create_string_buffer(max(size, 1))
    n = _check(lib, lib.ZSTD_decompress(out, size, blob, len(blob)), "decompress")
    return out.raw[:n]


def zstd_compress(data: bytes) -> bytes:
    lib = _libzstd()
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(out, cap, data, len(data), _ZSTD_LEVEL), "compress")
    return out.raw[:n]


def svb16_decode(raw: bytes, count: int, zigzag: bool = True, delta: bool = True) -> np.ndarray:
    """Decode an svb16 payload of ``count`` values to int16."""
    if count == 0:
        return np.zeros(0, dtype=np.int16)
    key_len = (count + 7) // 8
    keys = np.frombuffer(raw, np.uint8, count=key_len)
    bits = np.unpackbits(keys, bitorder="little")[:count].astype(np.int64)
    data = np.frombuffer(raw, np.uint8, offset=key_len)

    lens = bits + 1
    offsets = np.empty(count, dtype=np.int64)
    offsets[0] = 0
    np.cumsum(lens[:-1], out=offsets[1:])

    lo = data[offsets].astype(np.uint16)
    hi_idx = np.minimum(offsets + 1, len(data) - 1)
    hi = np.where(bits == 1, data[hi_idx], 0).astype(np.uint16)
    u = lo | (hi << np.uint16(8))

    if zigzag:
        vals = ((u >> np.uint16(1)) ^ (np.zeros_like(u) - (u & np.uint16(1)))).astype(np.int16)
    else:
        vals = u.view(np.int16)
    if delta:
        return np.cumsum(vals.astype(np.int64)).astype(np.int16)
    return vals


def svb16_encode(values: np.ndarray, zigzag: bool = True, delta: bool = True) -> bytes:
    """Encode int16 values as an svb16 payload (inverse of svb16_decode)."""
    values = np.asarray(values, dtype=np.int16)
    count = len(values)
    if count == 0:
        return b""
    if delta:
        work = np.diff(values.astype(np.int64), prepend=0)
        work = (work & 0xFFFF).astype(np.uint16)
    else:
        work = values.view(np.uint16)
    if zigzag:
        s = work.view(np.int16).astype(np.int32)
        work = ((s << 1) ^ (s >> 15)).astype(np.uint16)

    big = work > 0xFF
    key_len = (count + 7) // 8
    bits = np.zeros(key_len * 8, dtype=np.uint8)
    bits[:count] = big
    keys = np.packbits(bits, bitorder="little")

    lens = big.astype(np.int64) + 1
    offsets = np.concatenate([[0], np.cumsum(lens)])
    data = np.zeros(int(offsets[-1]), dtype=np.uint8)
    data[offsets[:-1]] = (work & 0xFF).astype(np.uint8)
    two = np.nonzero(big)[0]
    data[offsets[two] + 1] = (work[two] >> 8).astype(np.uint8)
    return keys.tobytes() + data.tobytes()


def decompress_signal(blob: bytes, sample_count: int) -> np.ndarray:
    """VBZ blob -> int16 signal of length sample_count."""
    if len(blob) == sample_count * 2:
        # an uncompressed signal table
        return np.frombuffer(blob, dtype=np.int16, count=sample_count).copy()
    max_out = (sample_count + 7) // 8 + 2 * sample_count
    raw = zstd_decompress(bytes(blob), max_out)
    # the svb16 payload must be exactly the key bytes and the data bytes of
    # sample_count values: a zstd frame without a checksum can decode a
    # corrupt input into garbage of the wrong length
    key_len = (sample_count + 7) // 8
    if len(raw) < key_len:
        raise ValueError("corrupt VBZ: payload shorter than svb16 key stream")
    nbits = int(
        np.unpackbits(np.frombuffer(raw, np.uint8, count=key_len), bitorder="little")[
            :sample_count
        ].sum()
    )
    if len(raw) != key_len + sample_count + nbits:
        raise ValueError("corrupt VBZ: svb16 payload size mismatch")
    return svb16_decode(raw, sample_count)


def compress_signal(signal: np.ndarray) -> bytes:
    """int16 signal -> VBZ blob (svb16 + zstd level 1)."""
    return zstd_compress(svb16_encode(np.asarray(signal, dtype=np.int16)))
