"""Basespace duplex: a consensus of already basecalled template and
complement calls, without their signals.

Port of ``dorado_tpu/duplex/basespace.py`` (parity with dorado/read_pipeline/
nodes/BaseSpaceDuplexCallerNode.cpp and dorado/torch_utils/duplex_utils.cpp):
min-pooled quality scores, a global alignment of the template and
RC(complement) (``utils.align``), the alignment trimmed to its first and last
run of ``min_consecutive`` matches, then a vote at each position for the
base of the higher quality.
"""

from __future__ import annotations

import numpy as np

from dorado_tpu_torch.utils.align import align
from dorado_tpu_torch.utils.sequence import reverse_complement


def preprocess_quality_scores(qscores: np.ndarray, pool_window: int = 5) -> np.ndarray:
    """Min-pool filter over phred bytes (duplex_utils.cpp:109-116)."""
    q = np.asarray(qscores, dtype=np.float32)
    pad = pool_window // 2
    padded = np.pad(q, pad, mode="constant", constant_values=np.inf)
    win = np.lib.stride_tricks.sliding_window_view(padded, pool_window)[: len(q)]
    return win.min(axis=1).astype(np.uint8)


def get_trimmed_alignment(
    num_consecutive_wanted: int,
    alignment: np.ndarray,
    target_cursor: int,
    query_cursor: int,
    start_pos: int,
    end_pos: int,
):
    """Trim the alignment's ends to runs of ``num_consecutive_wanted``
    matches (duplex_utils.cpp:47-105). Returns ((start, end), (query_cursor,
    target_cursor))."""
    n = len(alignment)
    num_consecutive = 0
    while num_consecutive < num_consecutive_wanted:
        if alignment[start_pos] != 2:
            target_cursor += 1
        if alignment[start_pos] != 1:
            query_cursor += 1
        if alignment[start_pos] == 0:
            num_consecutive += 1
        else:
            num_consecutive = 0
        start_pos += 1
        if start_pos >= n:
            break
    target_cursor -= num_consecutive_wanted
    query_cursor -= num_consecutive_wanted

    num_consecutive = 0
    while num_consecutive < num_consecutive_wanted:
        if alignment[end_pos] == 0:
            num_consecutive += 1
        else:
            num_consecutive = 0
        end_pos -= 1
        if end_pos < start_pos:
            break
    start_pos -= num_consecutive_wanted
    end_pos += num_consecutive_wanted
    return (start_pos, end_pos), (query_cursor, target_cursor)


def compute_basespace_consensus(
    start: int,
    end: int,
    target_q: np.ndarray,
    target_cursor: int,
    query_q: np.ndarray,
    query_cursor: int,
    target_seq: str,
    query_seq: str,
    alignment: np.ndarray,
) -> tuple[str, str]:
    """The quality vote along the alignment (BaseSpaceDuplexCallerNode.cpp:
    18-64): (sequence, qstring)."""
    consensus = []
    quals = []
    i = start
    while i < end and target_cursor < len(target_q) and query_cursor < len(query_q):
        if target_q[target_cursor] >= query_q[query_cursor]:
            if alignment[i] != 2:
                consensus.append(target_seq[target_cursor])
                quals.append(int(target_q[target_cursor]))
        elif alignment[i] != 1:
            consensus.append(query_seq[query_cursor])
            quals.append(int(query_q[query_cursor]))
        if alignment[i] != 2:
            target_cursor += 1
        if alignment[i] != 1:
            query_cursor += 1
        i += 1
    return "".join(consensus), bytes(quals).decode()


def basespace_duplex_call(
    template_seq: str,
    template_qstring: str,
    complement_seq: str,
    complement_qstring: str,
) -> tuple[str, str] | None:
    """(consensus sequence, qstring), or None without a confident overlap."""
    if not template_seq or not complement_seq:
        return None
    target_q = preprocess_quality_scores(np.frombuffer(template_qstring.encode(), np.uint8))
    query_q = preprocess_quality_scores(
        np.frombuffer(complement_qstring.encode(), np.uint8)[::-1]
    )
    comp_rc = reverse_complement(complement_seq)
    # global alignment with the template as the query: op 1 advances the
    # template only, op 2 RC(complement) only, as the reference's consensus
    # walk assumes (the template is edlib's query there too)
    res = align(template_seq, comp_rc)
    if res.distance < 0:
        return None
    alignment = res.ops
    short = min(len(template_seq), len(comp_rc)) < 500
    min_consecutive = 5 if short else 11
    (start, end), (q_cur, t_cur) = get_trimmed_alignment(
        min_consecutive, alignment, 0, 0, 0, len(alignment) - 1
    )
    min_len = 25 if short else 200
    if not (start < end and (end - start) > min_len):
        return None
    seq, qstring = compute_basespace_consensus(
        start, end, target_q, t_cur, query_q, q_cur, template_seq, comp_rc, alignment
    )
    if not seq:
        return None
    return seq, qstring
