"""Duplex (concatemer / template-complement chimera) read splitting.

Parity with dorado/splitter/DuplexReadSplitter.cpp: detect open-pore spike
regions in the signal, map them to sequence space via the move table, then
run the reference's chain of split finders — PORE_ADAPTER, PORE_FLANK,
PORE_ALL, ADAPTER_FLANK, ADAPTER_MIDDLE, SPLIT_MIDDLE — each confirming
candidate spacers via adapter matches and template/complement
reverse-complement flank matches.

Port of ``dorado_tpu/splitter/duplex_splitter.py`` over the port's own
aligner (``utils/align.py``); both modes, every finder.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dorado_tpu_torch.splitter.utils import (
    Subread,
    detect_pore_signal,
    merge_ranges,
    move_cum_sums,
    moves_to_map,
    qscore_mean,
)
from dorado_tpu_torch.utils.align import MODE_HW, align
from dorado_tpu_torch.utils.sequence import reverse_complement

PosRange = tuple[int, int]


@dataclass
class DuplexSplitSettings:
    enabled: bool = True
    simplex_mode: bool = False
    pore_thr: float = 2.4
    pore_cl_dist: int = 500
    max_pore_region: int = 500
    use_argmax: bool = True
    qscore_check_span: int = 5
    top_candidates: int = 10
    mean_qscore_thr: float = 10.0
    strand_end_flank: int = 1200
    strand_end_trim: int = 200
    strand_start_flank: int = 1700
    min_flank: int = 300
    flank_err: float = 0.15
    relaxed_flank_err: float = 0.275
    adapter_edist: int = 4
    relaxed_adapter_edist: int = 8
    pore_adapter_span: int = 50
    expect_adapter_prefix: int = 200
    expect_pore_prefix: int = 5000
    middle_adapter_search_span: int = 1000
    middle_adapter_search_frac: float = 0.2
    adapter: str = "TACTTCGTTCAGTTACGTATTGCT"

    @classmethod
    def for_pa_scaling(cls) -> "DuplexSplitSettings":
        # pA-scaled data uses a higher pore threshold (ReadSplitter.h:88-91)
        return cls(pore_thr=2.8)


@dataclass
class _ExtRead:
    seq: str
    qstring: str
    moves: np.ndarray
    signal: np.ndarray
    stride: int
    move_sums: np.ndarray = field(default=None)
    pore_regions: list[PosRange] = field(default_factory=list)


def _find_best_adapter_match(
    adapter: str, seq: str, dist_thr: int, subrange: PosRange
) -> PosRange | None:
    """(DuplexReadSplitter.cpp:31-55) best infix match within dist_thr."""
    start, end = subrange
    span = seq[start:end]
    if not span:
        return None
    res = align(adapter, span, mode=MODE_HW)
    if res.distance < 0 or res.distance > dist_thr:
        return None
    return (start + res.t_start, start + res.t_end)


def _check_rc_match(
    seq: str, templ_r: PosRange, compl_r: PosRange, dist_thr: int
) -> PosRange | None:
    """(DuplexReadSplitter.cpp:75-107) template region vs RC(complement
    region); returns match range in complement coordinates."""
    rc_compl = reverse_complement(seq[compl_r[0] : compl_r[1]])
    query = seq[templ_r[0] : templ_r[1]]
    res = align(query, rc_compl, mode=MODE_HW)
    if res.distance < 0 or res.distance > dist_thr:
        return None
    return (compl_r[1] - (res.t_end - 1), compl_r[1] - res.t_start)


class DuplexReadSplitter:
    def __init__(self, settings: DuplexSplitSettings | None = None):
        self.settings = settings or DuplexSplitSettings()

    # ------------------------------------------------------------------

    def _possible_pore_regions(self, read: _ExtRead) -> list[PosRange]:
        s = self.settings
        sample_ranges = detect_pore_signal(
            read.signal, s.pore_thr, s.pore_cl_dist, s.expect_pore_prefix
        )
        candidates: list[tuple[float, PosRange]] = []
        for r in sample_ranges:
            move_start = r.start_sample // read.stride
            move_end = r.end_sample // read.stride
            move_argmax = r.argmax_sample // read.stride
            if move_end >= len(read.move_sums) or read.move_sums[move_start] == 0:
                continue
            start_pos = int(read.move_sums[move_start]) - 1
            argmax_pos = int(read.move_sums[move_argmax]) - 1
            end_pos = int(read.move_sums[move_end])
            if end_pos > start_pos + s.max_pore_region:
                continue
            if s.use_argmax:
                start_pos = argmax_pos
                end_pos = argmax_pos + 1
            if (
                s.qscore_check_span > 0
                and qscore_mean(read.qstring, start_pos, start_pos + s.qscore_check_span)
                > s.mean_qscore_thr - 1e-7
            ):
                continue
            candidates.append((r.max_val, (start_pos, end_pos)))
        candidates.sort(key=lambda c: c[0])
        top = [c[1] for c in candidates[-s.top_candidates :]]
        top.sort()
        return top

    def _check_nearby_adapter(self, read: _ExtRead, r: PosRange, edist: int) -> bool:
        s = self.settings
        return (
            _find_best_adapter_match(
                s.adapter,
                read.seq,
                edist,
                (r[0], min(r[1] + s.pore_adapter_span, len(read.seq))),
            )
            is not None
        )

    def _check_flank_match(
        self, read: _ExtRead, spacer: PosRange, err_thr: float
    ) -> tuple[PosRange, PosRange] | None:
        s = self.settings
        rlen = len(read.seq)
        if spacer[0] <= s.strand_end_trim or spacer[1] == rlen:
            return None
        left_start = spacer[0] - s.strand_end_flank if spacer[0] > s.strand_end_flank else 0
        left_end = spacer[0] - s.strand_end_trim
        left_span = left_end - left_start
        right_start = spacer[0]
        right_end = min(spacer[1] + s.strand_start_flank + (spacer[1] - spacer[0]), rlen)
        right_span = right_end - right_start
        dist_thr = int(round(err_thr * left_span))
        if left_span >= s.min_flank and right_span >= left_span:
            match = _check_rc_match(
                read.seq, (left_start, left_end), (right_start, right_end), dist_thr
            )
            if match is not None:
                return ((left_start, left_end), match)
        return None

    def _identify_middle_adapter_split(self, read: _ExtRead) -> PosRange | None:
        s = self.settings
        r_l = len(read.seq)
        search_span = max(
            s.middle_adapter_search_span, int(round(s.middle_adapter_search_frac * r_l))
        )
        if r_l < search_span:
            return None
        adapter_match = _find_best_adapter_match(
            s.adapter,
            read.seq,
            s.relaxed_adapter_edist,
            (r_l // 2 - search_span // 2, r_l // 2 + search_span // 2),
        )
        if adapter_match is None:
            return None
        adapter_start, adapter_end = adapter_match
        if self._check_flank_match(read, (adapter_start, adapter_start), s.flank_err):
            query_start = r_l - s.strand_end_flank
            query_end = r_l - s.strand_end_trim
            query_span = query_end - query_start
            dist_thr = int(round(s.flank_err * query_span))
            template_end = min(s.strand_start_flank, adapter_start)
            template_span = template_end - 0
            if (
                adapter_end + s.strand_end_flank > r_l
                or template_span < query_span
                or _check_rc_match(
                    read.seq,
                    (r_l - s.strand_end_flank, r_l - s.strand_end_trim),
                    (0, min(s.strand_start_flank, r_l)),
                    dist_thr,
                )
            ):
                return (adapter_start - 1, adapter_start)
        return None

    def _identify_extra_middle_split(self, read: _ExtRead) -> PosRange | None:
        s = self.settings
        r_l = len(read.seq)
        ext_start_frac = 0.1
        ext_start_flank = max(int(ext_start_frac * r_l), s.strand_start_flank)
        if ext_start_flank + s.strand_end_flank > r_l:
            return None
        flank_edist = int(round(s.flank_err * (s.strand_end_flank - s.strand_end_trim)))
        templ_start_match = _check_rc_match(
            read.seq,
            (r_l - s.strand_end_flank, r_l - s.strand_end_trim),
            (0, min(r_l, ext_start_flank)),
            flank_edist,
        )
        if templ_start_match is None:
            return None
        if templ_start_match[1] + s.strand_end_flank > r_l:
            return None
        est_middle = (templ_start_match[1] + (r_l - s.strand_end_flank)) // 2
        min_split_margin = 100
        split_margin = max(min_split_margin, int(0.05 * r_l))
        ranges = self._check_flank_match(
            read, (est_middle - split_margin, est_middle + split_margin), s.flank_err
        )
        if ranges is None:
            return None
        est_middle = (ranges[0][1] + ranges[1][0]) // 2
        return (est_middle - 1, est_middle)

    # ------------------------------------------------------------------

    def _filter_ranges(self, ranges, predicate):
        return [r for r in ranges if predicate(r)]

    def _apply_finder(self, reads: list[_ExtRead], finder) -> list[_ExtRead]:
        out = []
        for read in reads:
            spacers = finder(read)
            if not spacers:
                out.append(read)
            else:
                out.extend(self._subreads_ext(read, spacers))
        return out

    def _subreads_ext(self, read: _ExtRead, spacers: list[PosRange]) -> list[_ExtRead]:
        subs = self._subreads(read, spacers)
        return [
            _make_ext(sr.seq, sr.qstring, sr.moves, sr.signal, read.stride, self)
            for sr in subs
        ]

    def _subreads(self, read: _ExtRead, spacers: list[PosRange]) -> list[Subread]:
        """(DuplexReadSplitter.cpp:497-534)"""
        stride = read.stride
        m = moves_to_map(read.moves, stride, len(read.signal))
        out: list[Subread] = []

        def emit(seq_r: PosRange, sig_r: tuple[int, int]):
            move_lo = int(sig_r[0]) // stride
            move_hi = int(sig_r[1]) // stride
            moves = np.asarray(read.moves[move_lo:move_hi], dtype=np.uint8).copy()
            if len(moves):
                moves[0] = 1
            out.append(
                Subread(
                    seq=read.seq[seq_r[0] : seq_r[1]],
                    qstring=read.qstring[seq_r[0] : seq_r[1]],
                    moves=moves,
                    signal=read.signal[sig_r[0] : sig_r[1]],
                    seq_range=seq_r,
                    signal_range=(int(sig_r[0]), int(sig_r[1])),
                )
            )

        start_pos = 0
        signal_start = int(m[0])
        for r in spacers:
            if start_pos < r[0] and signal_start // stride < int(m[r[0]]) // stride:
                emit((start_pos, r[0]), (signal_start, int(m[r[0]])))
            start_pos = r[1]
            signal_start = int(m[r[1]])
        if start_pos < len(read.seq) and signal_start // stride < len(read.signal) // stride:
            emit((start_pos, len(read.seq)), (signal_start, len(read.signal)))
        return out

    # ------------------------------------------------------------------

    def split(
        self,
        seq: str,
        qstring: str,
        moves: np.ndarray,
        signal: np.ndarray,
        stride: int,
    ) -> list[Subread]:
        """Split one basecalled read; returns >=1 subreads
        (apply_split_finders chain, DuplexReadSplitter.cpp:537-600)."""
        s = self.settings
        root = _make_ext(seq, qstring, moves, signal, stride, self)
        if len(seq) == 0:
            return [
                Subread(
                    seq=seq, qstring=qstring, moves=np.asarray(moves), signal=signal,
                    seq_range=None, signal_range=(0, len(signal)),
                )
            ]
        reads = [root]

        reads = self._apply_finder(
            reads,
            lambda rd: self._filter_ranges(
                rd.pore_regions,
                lambda r: self._check_nearby_adapter(rd, r, s.adapter_edist),
            ),
        )
        if not s.simplex_mode:
            reads = self._apply_finder(
                reads,
                lambda rd: merge_ranges(
                    self._filter_ranges(
                        rd.pore_regions,
                        lambda r: self._check_flank_match(rd, r, s.flank_err) is not None,
                    ),
                    s.strand_end_flank + s.strand_start_flank,
                ),
            )
            reads = self._apply_finder(
                reads,
                lambda rd: merge_ranges(
                    self._filter_ranges(
                        rd.pore_regions,
                        lambda r: self._check_nearby_adapter(rd, r, s.relaxed_adapter_edist)
                        and self._check_flank_match(rd, r, s.relaxed_flank_err) is not None,
                    ),
                    s.strand_end_flank + s.strand_start_flank,
                ),
            )

            def adapter_flank(rd: _ExtRead):
                if s.expect_adapter_prefix >= len(rd.seq):
                    return []
                m = _find_best_adapter_match(
                    s.adapter, rd.seq, s.adapter_edist, (s.expect_adapter_prefix, len(rd.seq))
                )
                matches = [m] if m else []
                return self._filter_ranges(
                    matches,
                    lambda r: self._check_flank_match(rd, (r[0], r[0]), s.flank_err)
                    is not None,
                )

            reads = self._apply_finder(reads, adapter_flank)
            reads = self._apply_finder(
                reads,
                lambda rd: [x]
                if (x := self._identify_middle_adapter_split(rd)) is not None
                else [],
            )
            reads = self._apply_finder(
                reads,
                lambda rd: [x]
                if (x := self._identify_extra_middle_split(rd)) is not None
                else [],
            )

        return [
            Subread(
                seq=rd.seq,
                qstring=rd.qstring,
                moves=rd.moves,
                signal=rd.signal,
                seq_range=None,
                signal_range=(0, len(rd.signal)),
            )
            for rd in reads
        ]


def _make_ext(seq, qstring, moves, signal, stride, splitter: DuplexReadSplitter) -> _ExtRead:
    ext = _ExtRead(
        seq=seq,
        qstring=qstring,
        moves=np.asarray(moves, dtype=np.uint8),
        signal=np.asarray(signal),
        stride=stride,
    )
    ext.move_sums = move_cum_sums(ext.moves)
    if len(seq):
        ext.pore_regions = splitter._possible_pore_regions(ext)
    return ext
