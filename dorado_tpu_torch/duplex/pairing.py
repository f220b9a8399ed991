"""Duplex pair detection over channel-ordered simplex calls.

Port of ``dorado_tpu/duplex/pairing.py``, with the same gates and constants
(after dorado/read_pipeline/nodes/PairingNode.cpp:17-116): candidate reads
must be pore-adjacent in time on the same channel and mux, pass the time
gap, length and qscore gates, and either be accepted early (near-identical
lengths, a gap under 100 ms) or pass an overlap check: the RC(complement)
aligned to the template (``utils.align``, global, unit cost) with a low
error rate over the alignment. The reference's overlap check uses minimap2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dorado_tpu_torch.utils.align import align
from dorado_tpu_torch.utils.sequence import mean_qscore_from_qstring, reverse_complement

MAX_TIME_DELTA_MS = 10000
MIN_SEQ_LENGTH = 500
MIN_QSCORE = 8.0
EARLY_ACCEPT_LEN_RATIO = 0.98
EARLY_ACCEPT_TIME_DELTA_MS = 100
EARLY_ACCEPT_MIN_LENGTH = 5000
MIN_LEN_RATIO = 0.2
MIN_OVERLAP_LENGTH = 50
MAX_OVERLAP_ERROR_RATE = 0.30


@dataclass
class CandidateRead:
    read_id: str
    channel: int
    mux: int
    start_time_ms: int
    duration_ms: int
    seq: str
    qstring: str
    moves: np.ndarray  # at the model's stride
    signal: np.ndarray  # scaled model-input signal
    payload: object = None  # the caller's record

    @property
    def end_time_ms(self) -> int:
        return self.start_time_ms + self.duration_ms


@dataclass
class PairingResult:
    template: CandidateRead
    complement: CandidateRead
    template_seq_start: int
    template_seq_end: int  # inclusive
    complement_seq_start: int
    complement_seq_end: int  # inclusive


def check_pair(
    temp: CandidateRead, comp: CandidateRead, use_alignment: bool = True
) -> PairingResult | None:
    """The pair (``temp`` then ``comp``) over both calls' whole lengths, or
    None where a gate rejects it."""
    delta = comp.start_time_ms - temp.end_time_ms
    len1, len2 = len(temp.seq), len(comp.seq)
    min_len, max_len = min(len1, len2), max(len1, len2)
    if min_len == 0:
        return None
    min_q = min(mean_qscore_from_qstring(temp.qstring), mean_qscore_from_qstring(comp.qstring))
    if delta < 0 or delta >= MAX_TIME_DELTA_MS or min_len < MIN_SEQ_LENGTH or min_q < MIN_QSCORE:
        return None
    len_ratio = min_len / max_len
    if (delta <= EARLY_ACCEPT_TIME_DELTA_MS and len_ratio >= EARLY_ACCEPT_LEN_RATIO
            and min_len >= EARLY_ACCEPT_MIN_LENGTH):
        return PairingResult(temp, comp, 0, len1 - 1, 0, len2 - 1)
    if len_ratio < MIN_LEN_RATIO or not use_alignment:
        return None
    # the overlap check: RC(complement) globally against the template, accepted
    # when the error rate over the alignment is low
    res = align(reverse_complement(comp.seq), temp.seq)
    if len(res.ops) < MIN_OVERLAP_LENGTH:
        return None
    if res.distance / max(1, len(res.ops)) > MAX_OVERLAP_ERROR_RATE:
        return None
    return PairingResult(temp, comp, 0, len1 - 1, 0, len2 - 1)


class DuplexPairer:
    """Streaming pairer over channel-ordered reads: each read is checked
    against the last read of its channel and mux (the cache of
    PairingNode::pair_generating_worker_thread, as a sequential scan: the
    reads come in channel order). A read belongs to one pair at most."""

    def __init__(self, use_alignment: bool = True):
        self._last: dict[tuple[int, int], CandidateRead] = {}
        self.use_alignment = use_alignment
        self.pairs_found = 0

    def push(self, read: CandidateRead) -> PairingResult | None:
        key = (read.channel, read.mux)
        prev = self._last.get(key)
        self._last[key] = read
        if prev is None:
            return None
        result = check_pair(prev, read, self.use_alignment)
        if result is not None:
            self.pairs_found += 1
            del self._last[key]  # both reads are taken
        return result
