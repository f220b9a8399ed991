"""Minimizer sketching (minimap2-style, from scratch, vectorised numpy).

Port of ``dorado_tpu/alignment/minimizer.py``, line for line.

Computes (k,w)-minimizers over 2-bit encoded sequences with an invertible
integer hash, canonical over strands: for each window of w consecutive
k-mers, the k-mer (in its lexicographically smaller strand orientation) with
the smallest hash is sampled. Replaces the role of minimap2's mm_sketch for
the from-scratch aligner (the reference links ont-minimap2; we do not copy
it).
"""

from __future__ import annotations

import numpy as np

_BASE_CODE = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _BASE_CODE[b] = i
for i, b in enumerate(b"acgt"):
    _BASE_CODE[b] = i


def encode_seq(seq: str | bytes) -> np.ndarray:
    b = seq.encode() if isinstance(seq, str) else seq
    return _BASE_CODE[np.frombuffer(b, dtype=np.uint8)]


def _invertible_hash(x: np.ndarray, mask: np.uint64) -> np.ndarray:
    """Thomas Wang's 64-bit invertible integer hash, masked to 2k bits
    (the standard minimizer hash; public-domain construction)."""
    x = x.astype(np.uint64)
    x = (~x + (x << np.uint64(21))) & mask
    x = x ^ (x >> np.uint64(24))
    x = (x + (x << np.uint64(3)) + (x << np.uint64(8))) & mask
    x = x ^ (x >> np.uint64(14))
    x = (x + (x << np.uint64(2)) + (x << np.uint64(4))) & mask
    x = x ^ (x >> np.uint64(28))
    x = (x + (x << np.uint64(31))) & mask
    return x


def minimizers(
    seq: str | bytes | np.ndarray, k: int = 15, w: int = 10
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (hashes u64, positions i64, strands u8) of the sequence's
    (k,w)-minimizers; strand 1 means the reverse-complement k-mer was
    canonical."""
    codes = seq if isinstance(seq, np.ndarray) else encode_seq(seq)
    n = len(codes)
    if n < k:
        return (
            np.zeros(0, np.uint64),
            np.zeros(0, np.int64),
            np.zeros(0, np.uint8),
        )
    valid = codes < 4
    codes = np.where(valid, codes, 0).astype(np.uint64)

    mask = np.uint64((1 << (2 * k)) - 1)
    # vectorised 2-bit packs: fwd[i] = sum codes[i+j] << 2*(k-1-j),
    # rev[i] = sum (3 ^ codes[i+j]) << 2*j (reverse complement)
    acc_f = np.zeros(n - k + 1, dtype=np.uint64)
    acc_r = np.zeros(n - k + 1, dtype=np.uint64)
    for j in range(k):
        window = codes[j : n - k + 1 + j]
        acc_f = (acc_f << np.uint64(2)) | window
        acc_r |= (np.uint64(3) ^ window) << np.uint64(2 * j)
    fwd = acc_f & mask
    rev = acc_r & mask

    # windows containing any N are invalid
    kmer_valid = np.ones(n - k + 1, dtype=bool)
    invalid_pos = np.flatnonzero(~valid)
    for p in invalid_pos:
        lo = max(0, p - k + 1)
        hi = min(n - k + 1, p + 1)
        kmer_valid[lo:hi] = False

    use_rev = rev < fwd
    canon = np.where(use_rev, rev, fwd)
    h = _invertible_hash(canon, mask)
    # exclude symmetric k-mers (fwd == rev) like minimap2 does
    ambiguous = fwd == rev
    h = np.where(kmer_valid & ~ambiguous, h, np.uint64(0xFFFFFFFFFFFFFFFF))

    if len(h) < w:
        w = len(h)
    win = np.lib.stride_tricks.sliding_window_view(h, w)
    arg = np.argmin(win, axis=1)
    pos = (np.arange(len(win)) + arg).astype(np.int64)
    sel_h = h[pos]
    keep_mask = sel_h != np.uint64(0xFFFFFFFFFFFFFFFF)
    # dedupe consecutive identical selections
    uniq = np.ones(len(pos), dtype=bool)
    uniq[1:] = pos[1:] != pos[:-1]
    sel = keep_mask & uniq
    return sel_h[sel], pos[sel], use_rev[pos[sel]].astype(np.uint8)
