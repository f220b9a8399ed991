"""Signal/sequence alignment and kmer one-hot encoding for modbase calling.

Port of ``dorado_tpu/modbase/encode.py``: numpy forms of the reference's
encoders (dorado/modbase/encode_kmer.cpp, dorado/utils/sequence_utils.cpp
moves_to_map / reverse_seq_to_sig_map).
"""

from __future__ import annotations

import numpy as np

_BASE_LOOKUP = np.full(256, -1, dtype=np.int32)
for _i, _b in enumerate(b"ACGT"):
    _BASE_LOOKUP[_b] = _i


def sequence_to_ints(seq: str) -> np.ndarray:
    return _BASE_LOOKUP[np.frombuffer(seq.encode(), dtype=np.uint8)]


def moves_to_map(moves: np.ndarray, block_stride: int, signal_len: int) -> np.ndarray:
    """Sequence position -> signal index, with ``signal_len`` as the last
    entry (sequence_utils.cpp:250-267)."""
    idx = np.flatnonzero(np.asarray(moves) == 1) * block_stride
    return np.concatenate([idx, [signal_len]]).astype(np.uint64)


def reverse_seq_to_sig_map(seq_to_sig: np.ndarray, signal_len: int) -> np.ndarray:
    """The mapping mirrored, for RNA models whose signal is reversed."""
    return (signal_len - seq_to_sig[::-1]).astype(np.uint64)


def encode_kmer_chunk(
    int_seq: np.ndarray,
    seq_to_sig: np.ndarray,
    kmer_len: int,
    context_samples: int,
    kmer_centered: bool = True,
) -> np.ndarray:
    """Per-sample kmer one-hot: [context_samples, kmer_len * 4] int8.

    Every sample in base s's span ``seq_to_sig[s]..seq_to_sig[s + 1]``
    carries the one-hot of the kmer around s; positions outside the sequence
    encode as an all-zero "N" (encode_kmer.cpp encode_kmer_chunk_generic).
    """
    int_seq = np.asarray(int_seq, dtype=np.int64)
    seq_len = len(int_seq)
    start_pos = kmer_len // 2 if kmer_centered else 0
    ext = np.full(seq_len + kmer_len - 1, -1, dtype=np.int64)
    ext[start_pos : start_pos + seq_len] = int_seq

    # kmers[s, k] = ext[s + k]
    kmers = np.lib.stride_tricks.sliding_window_view(ext, kmer_len)[:seq_len]

    # the base whose kmer each signal sample carries
    counts = np.clip(np.diff(seq_to_sig.astype(np.int64)), 0, None)
    sample_base = np.repeat(np.arange(seq_len), counts[:seq_len])

    out = np.zeros((context_samples, kmer_len, 4), dtype=np.int8)
    n = min(len(sample_base), context_samples)
    km = kmers[sample_base[:n]]  # [n, kmer_len]
    valid = km >= 0
    rows = np.repeat(np.arange(n)[:, None], kmer_len, axis=1)
    cols = np.repeat(np.arange(kmer_len)[None, :], n, axis=0)
    out[rows[valid], cols[valid], km[valid]] = 1
    return out.reshape(context_samples, kmer_len * 4)
