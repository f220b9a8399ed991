"""Mux-change read trimming.

Reads whose pore ended in a mux change / unblock carry low-quality garbage at
the 3' (pore-exit) end. The reference trims these after stitching and before
RNA reversal (read_pipeline/base/read_utils.cpp:68-168, applied at
BasecallerNode.cpp:254). Semantics reproduced exactly: reverse cumulative
quality scoring (q<=7: -1, q<=12: +1, else +10), argmin from the back picks
the trim point, guarded by minimum length 100, a 30%-of-read excessive-trim
cap, and a 5-base minimum trim.
"""

from __future__ import annotations

import numpy as np

MUX_CHANGE_END_REASONS = frozenset({"mux_change", "unblock_mux_change"})


def find_mux_change_trim_seq_index(qstring: str) -> int:
    """Index of the minimum reverse cumulative quality score
    (read_utils.cpp:68-111). Returns len-1 when no trim point is found."""
    size = len(qstring)
    if size == 0:
        return -1
    q = np.frombuffer(qstring.encode("ascii"), dtype=np.uint8).astype(np.int32)
    scores = np.where(q <= 7 + 33, -1, np.where(q <= 12 + 33, 1, 10))
    rev_cumsum = np.cumsum(scores[::-1])
    min_val = int(rev_cumsum.min())
    if min_val > -1:  # reference never updates past its cum_sum_min = -1 seed
        return size - 1
    # scanning back-to-front updates on <=, so the smallest i (largest
    # reversed index) achieving the minimum wins
    j = int(np.flatnonzero(rev_cumsum == min_val)[-1])
    return (size - 1 - j) - 1


def sequence_to_move_table_index(
    moves: np.ndarray, sequence_index: int, sequence_size: int
) -> int:
    """Move-table index of the ``sequence_index``-th base
    (utils/sequence_utils.cpp:201-247); -1 on inconsistent input."""
    moves_sz = len(moves)
    if (
        moves_sz == 0
        or sequence_index >= moves_sz
        or sequence_index >= sequence_size
        or sequence_size > moves_sz
    ):
        return -1
    ones = np.flatnonzero(moves)
    if sequence_index >= len(ones):
        return -1
    return int(ones[sequence_index])


def mux_change_trim(
    seq: str,
    qstring: str,
    moves: np.ndarray,
    signal: np.ndarray,
    stride: int,
    end_reason: str,
):
    """Returns (seq, qstring, moves, signal), trimmed when the read ended in
    a mux change (read_utils.cpp:113-168); inputs unchanged otherwise."""
    if end_reason not in MUX_CHANGE_END_REASONS:
        return seq, qstring, moves, signal
    size = len(qstring)
    if size < 100:
        return seq, qstring, moves, signal
    trim_seq_idx = find_mux_change_trim_seq_index(qstring)
    if trim_seq_idx < int(np.floor(size * 0.3)):
        return seq, qstring, moves, signal  # excessive trimming — do nothing
    if trim_seq_idx >= size - 5:
        return seq, qstring, moves, signal  # nothing to do
    trim_moves_idx = sequence_to_move_table_index(moves, trim_seq_idx, size)
    if trim_moves_idx < 0:
        return seq, qstring, moves, signal
    moves = moves[:trim_moves_idx]
    seq = seq[:trim_seq_idx]
    qstring = qstring[:trim_seq_idx]
    signal = signal[: len(moves) * stride]
    return seq, qstring, moves, signal
