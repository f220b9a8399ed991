"""Barcode classification (demultiplexing).

Port of ``dorado_tpu/demux/barcoder.py``: parity with
dorado/demux/BarcodeClassifier.cpp and the kit tables in
dorado/utils/barcode_kits.cpp (the port's own copy of the JAX package's
``barcode_kits_data.json``, release metadata). Scoring per read:

  1. locate the flank+mask context in the front/rear read windows (HW infix
     alignment with N-wildcard mask, flank score = 1 - dist/flank_len);
  2. globally align each padded barcode against the extracted mask window
     (penalty = edit distance);
  3. pick top/bottom, apply acceptance heuristics (max penalty, min flank
     score, best-vs-second-best separation, end proximity, double-end
     agreement), with a mid-strand flank check that flags unsplit reads.

Custom barcode sequences (``--barcode-sequences``) are handed to the
classifier (``custom_barcodes``) rather than registered process-wide as the
JAX package's ``add_custom_barcodes`` does, so one command's sequences never
reach the next command run in the same process.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path

from dorado_tpu_torch.utils.align import (
    BARCODE_EQUALITIES,
    MODE_HW,
    MODE_NW,
    align,
    make_equality_table,
)
from dorado_tpu_torch.utils.sequence import reverse_complement

_DATA_PATH = Path(__file__).parent / "barcode_kits_data.json"

UNCLASSIFIED = "unclassified"


@lru_cache(maxsize=1)
def _data() -> dict:
    with open(_DATA_PATH) as f:
        return json.load(f)


@lru_cache(maxsize=1)
def _eq_table() -> bytes:
    return make_equality_table(BARCODE_EQUALITIES)


def list_kits() -> list[str]:
    return sorted(_data()["kits"])


def get_kit_info(kit_name: str) -> dict | None:
    return _data()["kits"].get(kit_name)


def get_barcode_sequence(name: str, custom_barcodes: dict[str, str] | None = None) -> str:
    """A barcode's sequence: from ``custom_barcodes`` where it names it,
    else from the kit table."""
    if custom_barcodes and name in custom_barcodes:
        return custom_barcodes[name]
    return _data()["barcodes"][name]


def normalize_barcode_name(name: str) -> str:
    """BC%02d-style name -> barcode%02d (barcode_kits.cpp:1830-1849)."""
    digits = ""
    for ch in reversed(name):
        if ch.isdigit():
            digits = ch + digits
        else:
            break
    return f"barcode{digits}" if digits else name


@dataclass
class ScoringParams:
    max_barcode_penalty: int = 9
    barcode_end_proximity: int = 75
    min_barcode_penalty_dist: int = 3
    min_separation_only_dist: int = 6
    flank_left_pad: int = 5
    flank_right_pad: int = 10
    front_barcode_window: int = 175
    rear_barcode_window: int = 175
    min_flank_score: float = 0.5
    midstrand_flank_score: float = 0.95


@dataclass
class BarcodeScoreResult:
    barcode_name: str = UNCLASSIFIED
    kit: str = ""
    barcode_kit: str = ""
    variant: str = "n/a"
    penalty: int = -1
    top_penalty: int = -1
    bottom_penalty: int = -1
    flank_score: float = -1.0
    top_flank_score: float = -1.0
    bottom_flank_score: float = -1.0
    barcode_score: float = -1.0
    top_barcode_score: float = -1.0
    bottom_barcode_score: float = -1.0
    use_top: bool = False
    found_midstrand: bool = False
    top_barcode_pos: tuple[int, int] = (-1, -1)
    bottom_barcode_pos: tuple[int, int] = (-1, -1)


def _extract_mask_location(ops, t_start: int, query: str) -> int:
    """Target position where the N-mask region of the flank query ends
    (BarcodeClassifier.cpp:52-77)."""
    query_cursor = 0
    target_cursor = 0
    in_mask = False
    for op in ops:
        if query_cursor < len(query) and query[query_cursor] != "N" and in_mask:
            break
        if op == 0:  # match
            query_cursor += 1
            target_cursor += 1
            if query_cursor < len(query) and query[query_cursor] == "N":
                in_mask = True
        elif op == 3:  # mismatch
            query_cursor += 1
            target_cursor += 1
        elif op == 2:  # target-only
            target_cursor += 1
        elif op == 1:  # query-only
            query_cursor += 1
    return t_start + target_cursor


@dataclass
class _Candidate:
    kit: str
    barcode_kit: str
    barcode_names: list[str] = field(default_factory=list)
    barcodes1: list[str] = field(default_factory=list)
    barcodes1_rev: list[str] = field(default_factory=list)
    barcodes2: list[str] = field(default_factory=list)
    barcodes2_rev: list[str] = field(default_factory=list)
    top_context: str = ""
    top_left_buf: str = ""
    top_right_buf: str = ""
    top_context_rev: str = ""
    top_rev_left_buf: str = ""
    top_rev_right_buf: str = ""
    bottom_context: str = ""
    bottom_left_buf: str = ""
    bottom_right_buf: str = ""
    bottom_context_rev: str = ""
    bottom_rev_left_buf: str = ""
    bottom_rev_right_buf: str = ""


class BarcodeClassifier:
    def __init__(
        self,
        kit_name: str,
        allowed_barcodes: set[str] | None = None,
        kit_info: dict | None = None,
        custom_barcodes: dict[str, str] | None = None,
    ):
        """``kit_name`` from the kit table, or with ``kit_info`` a custom
        arrangement (``custom_kit.parse_custom_arrangement``) whose
        sequences ``custom_barcodes`` holds where the table does not;
        ``allowed_barcodes`` (normalised or kit names) limits the calls."""
        info = kit_info if kit_info is not None else get_kit_info(kit_name)
        if info is None:
            raise ValueError(f"unknown barcode kit {kit_name!r}")
        if not info["barcodes"]:
            raise ValueError(f"barcode kit {kit_name!r} lists no barcodes")
        self.kit_name = kit_name
        self.kit_info = info
        self.custom_barcodes = dict(custom_barcodes or {})
        self.params = ScoringParams(**info["scoring_params"])
        self.allowed = (
            {normalize_barcode_name(b) for b in allowed_barcodes}
            if allowed_barcodes
            else None
        )
        self.candidate = self._generate_candidate()

    def barcode_sequence(self, name: str) -> str:
        return get_barcode_sequence(name, self.custom_barcodes)

    # ------------------------------------------------------------------

    def _generate_candidate(self) -> _Candidate:
        info = self.kit_info
        p = self.params
        use_leading_flank = "SQK-RBK114" not in self.kit_name

        cand = _Candidate(kit=self.kit_name, barcode_kit=info["name"])
        ref_bc = self.barcode_sequence(info["barcodes"][0])
        mask = "N" * len(ref_bc)

        tff, trf = info["top_front_flank"], info["top_rear_flank"]
        cand.top_context = (tff if use_leading_flank else "") + mask + trf
        cand.top_left_buf = tff[max(0, len(tff) - p.flank_left_pad) :]
        cand.top_right_buf = trf[: p.flank_right_pad]

        tff_rc, trf_rc = reverse_complement(tff), reverse_complement(trf)
        cand.top_context_rev = trf_rc + mask + tff_rc
        cand.top_rev_left_buf = trf_rc[max(0, len(trf_rc) - p.flank_left_pad) :]
        cand.top_rev_right_buf = tff_rc[: p.flank_right_pad]

        if info["barcodes2"]:
            ref_bc2 = self.barcode_sequence(info["barcodes2"][0])
            mask2 = "N" * len(ref_bc2)
            bff, brf = info["bottom_front_flank"], info["bottom_rear_flank"]
            cand.bottom_context = (bff if use_leading_flank else "") + mask2 + brf
            cand.bottom_left_buf = bff[max(0, len(bff) - p.flank_left_pad) :]
            cand.bottom_right_buf = brf[: p.flank_right_pad]
            bff_rc, brf_rc = reverse_complement(bff), reverse_complement(brf)
            cand.bottom_context_rev = brf_rc + mask + bff_rc
            cand.bottom_rev_left_buf = brf_rc[max(0, len(brf_rc) - p.flank_left_pad) :]
            cand.bottom_rev_right_buf = bff_rc[: p.flank_right_pad]

        for i, name in enumerate(info["barcodes"]):
            bc = self.barcode_sequence(name)
            cand.barcode_names.append(name)
            cand.barcodes1.append(bc)
            cand.barcodes1_rev.append(reverse_complement(bc))
            if info["barcodes2"]:
                bc2 = self.barcode_sequence(info["barcodes2"][i])
                cand.barcodes2.append(bc2)
                cand.barcodes2_rev.append(reverse_complement(bc2))
        return cand

    # ------------------------------------------------------------------

    def _flank_fit(self, context: str, window: str, barcode_len: int):
        """(flank score, mask end loc, aln start, aln end)"""
        res = align(context, window, mode=MODE_HW, equalities=_eq_table())
        denom = max(1, len(context) - barcode_len)
        score = 1.0 - res.distance / denom
        bc_loc = _extract_mask_location(res.ops, res.t_start, context)
        return score, bc_loc, res.t_start, res.t_end

    def _barcode_penalty(self, barcode: str, window: str) -> int:
        return align(barcode, window, mode=MODE_NW).distance

    def _permitted(self, name: str) -> bool:
        return self.allowed is None or normalize_barcode_name(name) in self.allowed

    @staticmethod
    def _pick_top_or_bottom(tp, tf, bp, bf):
        if tp <= bp and tf >= bf:
            return True, tp, tf
        if bp <= tp and bf >= tf:
            return False, bp, bf
        if tp <= bp:
            return True, tp, tf
        return False, bp, bf

    # ------------------------------------------------------------------
    # scoring scenarios (single end / symmetric double end / different ends)
    # ------------------------------------------------------------------

    def _score_single_end(self, seq: str, rear: bool) -> list[BarcodeScoreResult]:
        p = self.params
        cand = self.candidate
        if rear:
            start = max(0, len(seq) - p.rear_barcode_window)
            window = seq[start : start + p.rear_barcode_window]
        else:
            start = 0
            window = seq[: p.front_barcode_window]

        barcode_len = len(cand.barcodes1[0])
        flank_score, bc_loc, a_start, a_end = self._flank_fit(
            cand.top_context, window, barcode_len
        )
        s_idx = max(0, bc_loc - len(cand.top_left_buf) - barcode_len)
        e_idx = bc_loc + len(cand.top_right_buf)
        mask_win = window[s_idx:e_idx]

        results = []
        for name, bc in zip(cand.barcode_names, cand.barcodes1):
            if not self._permitted(name):
                continue
            barcode = cand.top_left_buf + bc + cand.top_right_buf
            penalty = self._barcode_penalty(barcode, mask_win)
            res = BarcodeScoreResult(
                barcode_name=name, kit=cand.kit, barcode_kit=cand.barcode_kit
            )
            score = 1.0 - penalty / len(barcode)
            if rear:
                res.bottom_flank_score = res.flank_score = flank_score
                res.bottom_penalty = res.penalty = penalty
                res.use_top = False
                res.bottom_barcode_score = res.barcode_score = score
                res.bottom_barcode_pos = (start + a_start, start + a_end)
            else:
                res.top_flank_score = res.flank_score = flank_score
                res.top_penalty = res.penalty = penalty
                res.use_top = True
                res.top_barcode_score = res.barcode_score = score
                res.top_barcode_pos = (a_start, a_end)
            results.append(res)
        return results

    def _score_double_ends(self, seq: str) -> list[BarcodeScoreResult]:
        p = self.params
        cand = self.candidate
        top_win = seq[: p.front_barcode_window]
        bottom_start = max(0, len(seq) - p.rear_barcode_window)
        bottom_win = seq[bottom_start : bottom_start + p.rear_barcode_window]
        barcode_len = len(cand.barcodes1[0])

        tfs, t_loc, t_s, t_e = self._flank_fit(cand.top_context, top_win, barcode_len)
        t_si = max(0, t_loc - len(cand.top_left_buf) - barcode_len)
        t_mask = top_win[t_si : t_loc + len(cand.top_right_buf)]

        bfs, b_loc, b_s, b_e = self._flank_fit(
            cand.top_context_rev, bottom_win, barcode_len
        )
        b_si = max(0, b_loc - len(cand.top_rev_left_buf) - barcode_len)
        b_mask = bottom_win[b_si : b_loc + len(cand.top_rev_right_buf)]

        results = []
        for name, bc, bc_rev in zip(
            cand.barcode_names, cand.barcodes1, cand.barcodes1_rev
        ):
            if not self._permitted(name):
                continue
            barcode = cand.top_left_buf + bc + cand.top_right_buf
            barcode_rev = cand.top_rev_left_buf + bc_rev + cand.top_rev_right_buf
            tp = self._barcode_penalty(barcode, t_mask)
            bp = self._barcode_penalty(barcode_rev, b_mask)
            res = BarcodeScoreResult(
                barcode_name=name,
                kit=cand.kit,
                barcode_kit=cand.barcode_kit,
                top_penalty=tp,
                bottom_penalty=bp,
                top_flank_score=tfs,
                bottom_flank_score=bfs,
            )
            res.use_top, res.penalty, res.flank_score = self._pick_top_or_bottom(
                tp, tfs, bp, bfs
            )
            res.top_barcode_score = 1.0 - tp / len(barcode)
            res.bottom_barcode_score = 1.0 - bp / len(barcode_rev)
            res.barcode_score = (
                res.top_barcode_score if res.use_top else res.bottom_barcode_score
            )
            res.top_barcode_pos = (t_s, t_e)
            res.bottom_barcode_pos = (bottom_start + b_s, bottom_start + b_e)
            results.append(res)
        return results

    def _score_different_double_ends(self, seq: str) -> list[BarcodeScoreResult]:
        p = self.params
        cand = self.candidate
        top_win = seq[: p.front_barcode_window]
        bottom_start = max(0, len(seq) - p.rear_barcode_window)
        bottom_win = seq[bottom_start : bottom_start + p.rear_barcode_window]
        barcode_len = len(cand.barcodes1[0])

        # variant 1: top context front, RC(bottom context) rear
        t1_fs, t1_loc, t1_s, t1_e = self._flank_fit(cand.top_context, top_win, barcode_len)
        b1_fs, b1_loc, b1_s, b1_e = self._flank_fit(
            cand.bottom_context_rev, bottom_win, barcode_len
        )
        # variant 2: bottom context front, RC(top context) rear
        t2_fs, t2_loc, t2_s, t2_e = self._flank_fit(
            cand.bottom_context, top_win, barcode_len
        )
        b2_fs, b2_loc, b2_s, b2_e = self._flank_fit(
            cand.top_context_rev, bottom_win, barcode_len
        )

        def mask_of(window, loc, left_buf, right_buf):
            si = max(0, loc - len(left_buf) - barcode_len)
            return window[si : loc + len(right_buf)]

        t1_mask = mask_of(top_win, t1_loc, cand.top_left_buf, cand.top_right_buf)
        b1_mask = mask_of(
            bottom_win, b1_loc, cand.bottom_rev_left_buf, cand.bottom_rev_right_buf
        )
        t2_mask = mask_of(top_win, t2_loc, cand.bottom_left_buf, cand.bottom_right_buf)
        b2_mask = mask_of(
            bottom_win, b2_loc, cand.top_rev_left_buf, cand.top_rev_right_buf
        )

        results = []
        for i, name in enumerate(cand.barcode_names):
            if not self._permitted(name):
                continue
            bc1 = cand.barcodes1[i]
            bc2 = cand.barcodes2[i]
            bc1_rev = cand.barcodes1_rev[i]
            bc2_rev = cand.barcodes2_rev[i]

            barcode1 = cand.top_left_buf + bc1 + cand.top_right_buf
            barcode2_rev = cand.bottom_rev_left_buf + bc2_rev + cand.bottom_rev_right_buf
            barcode2 = cand.bottom_left_buf + bc2 + cand.bottom_right_buf
            barcode1_rev = cand.top_rev_left_buf + bc1_rev + cand.top_rev_right_buf

            v1_tp = self._barcode_penalty(barcode1, t1_mask)
            v1_bp = self._barcode_penalty(barcode2_rev, b1_mask)
            v2_tp = self._barcode_penalty(barcode2, t2_mask)
            v2_bp = self._barcode_penalty(barcode1_rev, b2_mask)

            v1 = BarcodeScoreResult(
                barcode_name=name,
                kit=cand.kit,
                barcode_kit=cand.barcode_kit,
                top_penalty=v1_tp,
                bottom_penalty=v1_bp,
                top_flank_score=t1_fs,
                bottom_flank_score=b1_fs,
                top_barcode_pos=(t1_s, t1_e),
                bottom_barcode_pos=(bottom_start + b1_s, bottom_start + b1_e),
            )
            v1.use_top, v1.penalty, v1.flank_score = self._pick_top_or_bottom(
                v1_tp, t1_fs, v1_bp, b1_fs
            )
            v1.top_barcode_score = 1.0 - v1_tp / len(barcode1)
            v1.bottom_barcode_score = 1.0 - v1_bp / len(barcode2_rev)
            v1.barcode_score = (
                v1.top_barcode_score if v1.use_top else v1.bottom_barcode_score
            )

            v2 = BarcodeScoreResult(
                barcode_name=name,
                kit=cand.kit,
                barcode_kit=cand.barcode_kit,
                top_penalty=v2_tp,
                bottom_penalty=v2_bp,
                top_flank_score=t2_fs,
                bottom_flank_score=b2_fs,
                top_barcode_pos=(t2_s, t2_e),
                bottom_barcode_pos=(bottom_start + b2_s, bottom_start + b2_e),
            )
            v2.use_top, v2.penalty, v2.flank_score = self._pick_top_or_bottom(
                v2_tp, t2_fs, v2_bp, b2_fs
            )
            v2.top_barcode_score = 1.0 - v2_tp / len(barcode2)
            v2.bottom_barcode_score = 1.0 - v2_bp / len(barcode1_rev)
            v2.barcode_score = (
                v2.top_barcode_score if v2.use_top else v2.bottom_barcode_score
            )

            total_v1 = v1_tp + v1_bp
            total_v2 = v2_tp + v2_bp
            if v1.penalty <= v2.penalty and total_v1 <= total_v2:
                best = v1
            elif v2.penalty <= v1.penalty and total_v2 <= total_v1:
                best = v2
            elif v1.penalty <= v2.penalty:
                best = v1
            else:
                best = v2
            best.variant = "var1" if best is v1 else "var2"
            results.append(best)
        return results

    # ------------------------------------------------------------------

    def _midstrand_score(self, seq: str) -> float:
        p = self.params
        cand = self.candidate
        info = self.kit_info
        end_windows = p.front_barcode_window + p.rear_barcode_window
        if len(seq) < end_windows:
            return 0.0
        mid = seq[p.front_barcode_window : len(seq) - p.rear_barcode_window]
        barcode_len = len(cand.barcodes1[0])

        contexts: list[str]
        if info["double_ends"]:
            if info["ends_different"]:
                contexts = [
                    cand.top_context,
                    cand.bottom_context_rev,
                    cand.bottom_context,
                    cand.top_context_rev,
                ]
            else:
                contexts = [cand.top_context, cand.top_context_rev]
        else:
            contexts = [cand.top_context]
        if len(mid) < min(len(c) for c in contexts):
            return 0.0
        best = 0.0
        for c in contexts:
            score, *_ = self._flank_fit(c, mid, barcode_len)
            best = max(best, score)
        return best

    def classify(self, seq: str, barcode_both_ends: bool = False) -> BarcodeScoreResult:
        """Best barcode for a read sequence, or unclassified
        (BarcodeClassifier.cpp find_best_barcode)."""
        if not seq:
            return BarcodeScoreResult()
        info = self.kit_info
        p = self.params

        if self._midstrand_score(seq) >= p.midstrand_flank_score:
            return BarcodeScoreResult(found_midstrand=True)

        if info["double_ends"]:
            if info["ends_different"]:
                results = self._score_different_double_ends(seq)
            else:
                results = self._score_double_ends(seq)
        else:
            results = self._score_single_end(seq, info["rear_only_barcodes"])

        if not results:
            return BarcodeScoreResult()
        results.sort(key=lambda r: r.penalty)
        best = results[0]

        def acceptable(r):
            return r.penalty == 0 or (
                r.penalty <= p.max_barcode_penalty and r.flank_score >= p.min_flank_score
            )

        out = BarcodeScoreResult()
        if len(results) == 1:
            if acceptable(best):
                out = best
        else:
            second = results[1]
            penalty_dist = second.penalty - best.penalty
            proximity_ok = (
                0 <= best.top_barcode_pos[0] <= p.barcode_end_proximity
            ) or (
                best.bottom_barcode_pos[1] >= 0
                and best.bottom_barcode_pos[1] >= len(seq) - p.barcode_end_proximity
            )
            if (
                (penalty_dist >= p.min_barcode_penalty_dist and acceptable(best))
                or penalty_dist >= p.min_separation_only_dist
            ) and proximity_ok:
                out = best

        if barcode_both_ends and info["double_ends"]:
            if max(out.top_penalty, out.bottom_penalty) > p.max_barcode_penalty:
                return BarcodeScoreResult()

        if info["double_ends"] and out.barcode_name != UNCLASSIFIED:
            best_top = min(results, key=lambda r: r.top_penalty)
            best_bottom = min(results, key=lambda r: r.bottom_penalty)
            if (
                out.barcode_name != best_top.barcode_name
                and best_top.top_penalty <= p.max_barcode_penalty
            ) or (
                out.barcode_name != best_bottom.barcode_name
                and best_bottom.bottom_penalty <= p.max_barcode_penalty
            ):
                return BarcodeScoreResult()
        return out


def determine_barcode_trim_interval(res: BarcodeScoreResult, seqlen: int):
    """Retained [start, end) after removing confidently-located barcode
    regions (demux/Trimmer.cpp:40-91)."""
    interval = [0, seqlen]
    if res.kit == UNCLASSIFIED or res.barcode_name == UNCLASSIFIED:
        return tuple(interval)
    flank_thres = 0.6
    if res.top_penalty >= 0 and res.top_flank_score > flank_thres:
        interval[0] = res.top_barcode_pos[1] + 1
    if res.bottom_penalty >= 0 and res.bottom_flank_score > flank_thres:
        interval[1] = res.bottom_barcode_pos[0]
    if interval[1] <= interval[0]:
        if res.use_top:
            interval = [res.top_barcode_pos[1] + 1, seqlen]
        else:
            interval = [0, res.bottom_barcode_pos[0]]
    if interval[1] <= interval[0]:
        interval = [0, seqlen]
    return tuple(interval)
