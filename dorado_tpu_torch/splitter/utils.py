"""Shared splitter utilities (port of ``dorado_tpu/splitter/utils.py``;
parity: dorado/splitter/splitter_utils.h detect_pore_signal and the range
filtering/merging helpers in DuplexReadSplitter.cpp)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SampleRange:
    start_sample: int
    end_sample: int
    argmax_sample: int
    max_val: float


@dataclass
class Subread:
    seq: str
    qstring: str
    moves: np.ndarray
    signal: np.ndarray
    seq_range: tuple[int, int] | None  # [start, end) in parent sequence
    signal_range: tuple[int, int]  # [start, end) in parent signal


def detect_pore_signal(
    signal: np.ndarray, threshold: float, cluster_dist: int, ignore_prefix: int
) -> list[SampleRange]:
    """Clusters of above-threshold samples (open-pore spikes),
    vectorised version of splitter_utils.h:32-70."""
    sig = np.asarray(signal)
    above = np.flatnonzero(sig[ignore_prefix:] > threshold) + ignore_prefix
    if above.size == 0:
        return []
    # new cluster when the gap to the previous above-threshold sample
    # exceeds cluster_dist (reference: i > cl_end + cluster_dist with
    # cl_end = prev + 1)
    gaps = np.diff(above)
    breaks = np.flatnonzero(gaps > cluster_dist + 1) + 1
    out = []
    for grp in np.split(above, breaks):
        vals = sig[grp]
        am = int(grp[np.argmax(vals)])
        out.append(
            SampleRange(int(grp[0]), int(grp[-1] + 1), am, float(vals.max()))
        )
    return out


def merge_ranges(ranges: list[tuple[int, int]], max_dist: int) -> list[tuple[int, int]]:
    """Merge ranges closer than max_dist (splitter_utils merge_ranges)."""
    if not ranges:
        return []
    out = [list(ranges[0])]
    for r in ranges[1:]:
        if r[0] < out[-1][1] + max_dist:
            out[-1][1] = max(out[-1][1], r[1])
        else:
            out.append(list(r))
    return [(a, b) for a, b in out]


def move_cum_sums(moves: np.ndarray) -> np.ndarray:
    return np.cumsum(np.asarray(moves, dtype=np.int64))


def qscore_mean(qstring: str, start: int, end: int) -> float:
    end = min(end, len(qstring))
    arr = np.frombuffer(qstring.encode()[start:end], dtype=np.uint8)
    return float(arr.mean() - 33.0) if arr.size else 0.0


def moves_to_map(moves: np.ndarray, block_stride: int, signal_len: int) -> np.ndarray:
    """seq position -> signal index; final entry is signal_len
    (sequence_utils.cpp:250-267)."""
    idx = np.flatnonzero(np.asarray(moves) == 1) * block_stride
    return np.concatenate([idx, [signal_len]]).astype(np.uint64)
