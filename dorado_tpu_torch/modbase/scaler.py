"""Kmer-level rough signal rescaling for modbase models.

Port of ``dorado_tpu/modbase/scaler.py`` (parity: dorado/modbase/
ModBaseScaler.cpp): fits the expected kmer current levels against the
signal at each base's midpoint by a linear regression of their quantiles,
and applies ``signal * scale + offset``.
"""

from __future__ import annotations

import numpy as np


def index_from_int_kmer(kmers: np.ndarray, kmer_len: int) -> np.ndarray:
    """[..., kmer_len] base ints -> flat kmer index, first base most
    significant (ModBaseScaler.cpp index_from_int_kmer)."""
    weights = 4 ** np.arange(kmer_len - 1, -1, -1, dtype=np.int64)
    return (np.clip(kmers, 0, 3).astype(np.int64) * weights).sum(axis=-1)


def _quantiles(data: np.ndarray, quants: np.ndarray) -> np.ndarray:
    """Linearly interpolated quantiles (utils/math_utils.h:30-59)."""
    data = np.sort(np.asarray(data, dtype=np.float64))
    if data.size == 0:
        return np.array([])
    if data.size == 1:
        return np.full(1, data[0])
    pos = quants * (data.size - 1)
    left = np.clip(np.floor(pos).astype(np.int64), 0, None)
    right = np.minimum(np.ceil(pos).astype(np.int64), data.size - 1)
    t = pos - left
    return (1 - t) * data[left] + t * data[right]


class ModBaseScaler:
    def __init__(self, kmer_levels: np.ndarray, kmer_len: int, center_idx: int):
        kmer_levels = np.asarray(kmer_levels, dtype=np.float32)
        if kmer_levels.size != 4**kmer_len:
            raise ValueError("refinement levels have invalid size for kmer length")
        self.kmer_levels = kmer_levels
        self.kmer_len = kmer_len
        self.center_idx = center_idx

    def extract_levels(self, int_seq: np.ndarray) -> np.ndarray:
        """The expected level at each base (kmers placed at center_idx)."""
        int_seq = np.asarray(int_seq)
        levels = np.zeros(len(int_seq), dtype=np.float32)
        n = len(int_seq) - self.kmer_len
        if n <= 0:
            return levels
        kmers = np.lib.stride_tricks.sliding_window_view(int_seq, self.kmer_len)[:n]
        idx = index_from_int_kmer(kmers, self.kmer_len)
        levels[self.center_idx : self.center_idx + n] = self.kmer_levels[idx]
        return levels

    def calc_offset_scale(
        self,
        signal: np.ndarray,
        seq_to_sig: np.ndarray,
        levels: np.ndarray,
        clip_bases: int = 10,
        max_bases: int = 1000,
    ) -> tuple[float, float]:
        n = min(len(seq_to_sig) - 1, max_bases)
        mid = (seq_to_sig[:n].astype(np.int64) + seq_to_sig[1 : n + 1].astype(np.int64)) // 2
        optim_dacs = np.asarray(signal, dtype=np.float32)[mid]
        new_levels = np.asarray(levels[:n], dtype=np.float32)
        if clip_bases > 0 and len(levels) > clip_bases * 2:
            new_levels = new_levels[clip_bases:-clip_bases]
            optim_dacs = optim_dacs[clip_bases:-clip_bases]

        quants = (np.arange(19, dtype=np.float64) + 1) * 0.05
        x = _quantiles(optim_dacs, quants)  # observed
        y = _quantiles(new_levels, quants)  # expected
        nq = len(x)
        sumx2 = (x * x).sum()
        sumx, sumy = x.sum(), y.sum()
        sumxy = (x * y).sum()
        denom = nq * sumx2 - sumx * sumx
        if denom == 0:
            return 0.0, 1.0
        m = (nq * sumxy - sumx * sumy) / denom
        b = (sumy * sumx2 - sumx * sumxy) / denom
        return float(b), float(m)

    def scale_signal(
        self, signal: np.ndarray, int_seq: np.ndarray, seq_to_sig: np.ndarray
    ) -> np.ndarray:
        levels = self.extract_levels(int_seq)
        offset, scale = self.calc_offset_scale(signal, seq_to_sig, levels)
        return signal * scale + offset
