"""Stitch per-chunk basecalls back into a full-read call.

Consecutive chunks overlap; the stitcher trims each pair of neighbours at the
midpoint of the (downsampled) overlap and concatenates sequence, qstring and
move table. Trim arithmetic matches the reference
(dorado/read_pipeline/base/stitch.cpp:12-97) to keep output identical.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CalledChunk:
    seq: str
    qstring: str
    moves: np.ndarray  # uint8 [T_out]
    input_offset: int  # sample offset of this chunk within the read
    raw_chunk_size: int  # number of real (unpadded) samples in this chunk


@dataclass
class StitchedRead:
    seq: str
    qstring: str
    moves: np.ndarray  # uint8


def stitch_chunks(
    chunks: list[CalledChunk], model_stride: int, num_samples: int
) -> StitchedRead:
    """Merge overlapping called chunks into one read-level call.

    ``num_samples`` is the read's raw sample count (after any trimming),
    used to clip the single-chunk case and the trailing partial stride.
    """
    start_pos = 0
    mid_point_front = 0
    moves_parts: list[np.ndarray] = []
    seq_parts: list[str] = []
    q_parts: list[str] = []

    for i in range(len(chunks) - 1):
        cur = chunks[i]
        nxt = chunks[i + 1]
        overlap_size = (cur.raw_chunk_size + cur.input_offset) - nxt.input_offset
        if overlap_size % model_stride != 0:
            raise ValueError("stitch_chunks: overlap not stride-aligned")
        overlap_down = overlap_size // model_stride
        mid_point_rear = overlap_down // 2

        bases_to_trim = (
            int(np.sum(cur.moves[len(cur.moves) - mid_point_rear:]))
            if mid_point_rear > 0
            else 0
        )
        end_pos = len(cur.seq) - bases_to_trim
        seq_parts.append(cur.seq[start_pos:end_pos])
        q_parts.append(cur.qstring[start_pos:end_pos])

        moves_parts.append(cur.moves[mid_point_front : len(cur.moves) - mid_point_rear])

        mid_point_front = overlap_down - mid_point_rear
        start_pos = int(np.sum(nxt.moves[:mid_point_front]))

    last = chunks[-1]
    moves_parts.append(last.moves[mid_point_front:])
    moves = (
        np.concatenate(moves_parts)
        if len(moves_parts) > 1
        else np.asarray(moves_parts[0])
    )

    if len(chunks) == 1:
        # A read shorter than the chunk: clip everything past the real samples.
        keep = num_samples // model_stride
        moves = moves[:keep]
        end = int(np.sum(moves))
        seq_parts.append(last.seq[start_pos : start_pos + end])
        q_parts.append(last.qstring[start_pos : start_pos + end])
    else:
        seq_parts.append(last.seq[start_pos:])
        q_parts.append(last.qstring[start_pos:])

    seq = "".join(seq_parts)
    qstring = "".join(q_parts)

    # Remove any partial-stride overhang at the read end.
    if len(moves) > num_samples // model_stride:
        if len(moves) and moves[-1] == 1:
            seq = seq[:-1]
            qstring = qstring[:-1]
        moves = moves[:-1]
        assert int(np.sum(moves)) == len(seq)

    return StitchedRead(seq=seq, qstring=qstring, moves=np.ascontiguousarray(moves))
