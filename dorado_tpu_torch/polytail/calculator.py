"""Poly(A)/poly(T) tail length estimation.

Port of ``dorado_tpu/polytail/calculator.py``: parity with dorado/poly_tail/: anchor location from primer/adapter alignment
(poly_tail/dna_poly_tail_calculator.cpp:19-97,
rna_poly_tail_calculator.cpp:51-95), samples-per-base estimation from the
move table (poly_tail_calculator.cpp:44-80), low-variance interval detection
with glitch/interruption merging (poly_tail_calculator.cpp:82-270), and base
count conversion with per-platform signal-length adjustment.

The sliding-window interval scan is vectorised with prefix sums; the merge
passes follow the reference's sequential semantics exactly.
"""

from __future__ import annotations

import copy
import tomllib
from dataclasses import dataclass

import numpy as np

from dorado_tpu_torch.demux.barcoder import UNCLASSIFIED
from dorado_tpu_torch.modbase.encode import moves_to_map
from dorado_tpu_torch.utils.align import MODE_HW, align
from dorado_tpu_torch.utils.sequence import reverse_complement

MAX_TAIL_LENGTH = 750
BACKWARD = "backward"
FORWARD = "forward"


@dataclass
class PolyTailConfig:
    rna_adapter: str = "GGTTGTTTCTGTTGGTGCTG"
    front_primer: str = "TTTCTGTTGGTGCTGATATTGCTTT"  # SSP
    rear_primer: str = "ACTTGCCTGTCGCTCTATCTTCAGAGGAGAGTCCGCCGCCCGCAAGTTTT"  # VNP
    primer_window: int = 150
    min_primer_separation: int = 10
    flank_threshold: float = 0.6
    is_plasmid: bool = False
    tail_interrupt_length: int = 0
    min_base_count: int = 10
    rna_offset: int = 10
    # [status] enabled=false disables estimation for this (barcode's) config
    # (poly_tail_config.cpp:25-30, PolyTailCalculator::enabled)
    enabled: bool = True

    @property
    def rc_front_primer(self) -> str:
        return reverse_complement(self.front_primer)

    @property
    def rc_rear_primer(self) -> str:
        return reverse_complement(self.rear_primer)


@dataclass
class SignalAnchorInfo:
    search_dir: str
    signal_anchor: int
    trailing_adapter_bases: int = 0


@dataclass
class PolyTailResult:
    num_bases: int = -1
    signal_anchor: int = -1  # trimmed-space anchor (POLY_TAIL_NOT_FOUND=-1)
    signal_range: tuple[int, int] = (-1, -1)
    split_signal_range: tuple[int, int] = (-1, -1)


@dataclass
class ReadContext:
    """The slice of read state the calculator needs."""

    seq: str
    moves: np.ndarray
    signal: np.ndarray  # scaled model-input signal
    stride: int
    num_trimmed_samples: int = 0
    flow_cell_product_code: str = ""
    rna_adapter_end_signal_pos: int = 0


def _quantiles(data: np.ndarray, quants) -> np.ndarray:
    data = np.sort(np.asarray(data, dtype=np.float64))
    if data.size == 0:
        return np.zeros(len(quants))
    if data.size == 1:
        return np.full(len(quants), data[0])
    pos = np.asarray(quants) * (data.size - 1)
    left = np.floor(pos).astype(np.int64)
    right = np.minimum(np.ceil(pos).astype(np.int64), data.size - 1)
    t = pos - left
    return (1 - t) * data[left] + t * data[right]


class PolyTailCalculator:
    def __init__(self, config: PolyTailConfig, speed: float | None = None, offset: float | None = None):
        self.config = config
        self.speed = speed
        self.offset = offset

    # --- virtuals -----------------------------------------------------
    def determine_signal_anchor_and_strand(self, read: ReadContext) -> list[SignalAnchorInfo]:
        raise NotImplementedError

    def average_samples_per_base(self, sizes: np.ndarray) -> float:
        raise NotImplementedError

    def signal_length_adjustment(self, read: ReadContext, signal_len: int) -> int:
        raise NotImplementedError

    def min_avg_val(self) -> float:
        raise NotImplementedError

    def buffer_range(self, interval: tuple[int, int], samples_per_base: float) -> tuple[int, int]:
        span = interval[1] - interval[0]
        return span, span

    def signal_range(self, anchor: int, signal_len: int, samples_per_base: float, direction: str):
        spread = int(round(samples_per_base * MAX_TAIL_LENGTH))
        start_scale = 1.0 if direction == BACKWARD else 0.1
        end_scale = 0.1 if direction == BACKWARD else 1.0
        return (
            max(0, int(anchor - spread * start_scale)),
            min(signal_len, int(anchor + spread * end_scale)),
        )

    # --- shared machinery --------------------------------------------
    def _seq_to_sig_map(self, read: ReadContext) -> np.ndarray:
        return moves_to_map(read.moves, read.stride, len(read.signal))

    def estimate_samples_per_base(self, read: ReadContext) -> tuple[float, float]:
        m = self._seq_to_sig_map(read)
        sizes = np.diff(m.astype(np.float64)).astype(np.float32)
        avg = self.average_samples_per_base(sizes)
        if avg > 1000 or avg < 1:
            return 0.0, 0.0
        q10, q90 = _quantiles(sizes, [0.1, 0.9])
        sel = (sizes >= q10) & (sizes <= q90)
        count = int(sel.sum())
        stddev = float(np.sqrt(((sizes[sel] - avg) ** 2).sum() / count)) if count else 0.0
        return avg * (self.speed if self.speed is not None else 1.0), stddev

    def determine_signal_bounds(
        self,
        anchor: int,
        direction: str,
        read: ReadContext,
        samples_per_base: float,
        std_samples_per_base: float,
    ) -> tuple[int, int]:
        signal = np.asarray(read.signal, dtype=np.float32)
        signal_len = len(signal)
        k_var = 0.35
        k_mean_prox = 0.25
        window = int(round(samples_per_base * 5))
        max_gap = int(round(samples_per_base * 2))
        min_avg = self.min_avg_val()
        stride = 3

        left, right = self.signal_range(anchor, signal_len, samples_per_base, direction)
        if right - window <= left or window <= 0:
            return -1, -1

        # vectorised sliding stats at stride-3 window starts
        starts = np.arange(left, right - window, stride)
        csum = np.concatenate([[0.0], np.cumsum(signal, dtype=np.float64)])
        csum2 = np.concatenate([[0.0], np.cumsum(signal.astype(np.float64) ** 2)])
        w_sum = csum[starts + window] - csum[starts]
        w_sum2 = csum2[starts + window] - csum2[starts]
        avg = w_sum / window
        var = np.maximum(w_sum2 / window - avg * avg, 0.0)
        ok = (avg > min_avg) & (np.sqrt(var) < k_var)

        intervals: list[list] = []  # [start, end, avg]
        for idx in np.nonzero(ok)[0]:
            s = int(starts[idx])
            e = s + window
            a = float(avg[idx])
            if intervals and intervals[-1][1] >= s:
                last = intervals[-1]
                if abs(a - last[2]) < k_mean_prox:
                    last[2] = float((csum[e] - csum[last[0]]) / (e - last[0]))
                    last[1] = e
                    continue
            intervals.append([s, e, a])

        # cluster with glitch skips and configured interruptions
        max_interruption = int(
            np.floor((samples_per_base + 3 * std_samples_per_base) * self.config.tail_interrupt_length)
        )
        min_merge_size = window * 2

        def merge_pass(ivs):
            merged = []
            i = 0
            while i < len(ivs):
                cur = list(ivs[i])
                total = cur[1] - cur[0]
                wsum = cur[2] * total
                j = i + 1
                while j < len(ivs):
                    cand = ivs[j]
                    sep = cand[0] - cur[1]
                    skip_glitch = sep < max_gap
                    allow_linker = 0 <= sep < max_interruption
                    if not (skip_glitch or allow_linker):
                        break
                    mean_ok = abs(cand[2] - cur[2]) < k_mean_prox
                    size_ok = (cur[1] - cur[0]) > min_merge_size and (
                        (cand[1] - cand[0]) > min_merge_size or cand[1] >= right - stride
                    )
                    if size_ok and mean_ok:
                        ln = cand[1] - cand[0]
                        wsum += cand[2] * ln
                        total += ln
                        cur[1] = max(cur[1], cand[1])
                        cur[2] = wsum / total
                        i = j
                    j += 1
                merged.append(cur)
                i += 1
            return merged

        while True:
            clustered = merge_pass(intervals)
            if len(clustered) == len(intervals):
                break
            intervals = clustered

        filtered = []
        for s, e, a in intervals:
            buf = self.buffer_range((s, e), samples_per_base)
            within = max(0, s - buf[0]) <= anchor <= e + buf[1]
            long_enough = (e - s) >= round(samples_per_base * self.config.min_base_count)
            if within and long_enough:
                filtered.append((s, e, a))
        if not filtered:
            return -1, -1

        def keyfn(iv):
            s, e, _ = iv
            closeness = (
                -abs(e - anchor) if direction == BACKWARD else -abs(s - anchor)
            )
            return (e - s, closeness)

        best = max(filtered, key=keyfn)
        return best[0], best[1]

    def calculate_num_bases(self, read: ReadContext) -> PolyTailResult:
        info = self.determine_signal_anchor_and_strand(read)
        if not info:
            return PolyTailResult()
        spb, std = self.estimate_samples_per_base(read)
        if spb == 0:
            return PolyTailResult()
        start, end = self.determine_signal_bounds(
            info[0].signal_anchor, info[0].search_dir, read, spb, std
        )
        if (start, end) == (-1, -1):
            return PolyTailResult()
        trailing = info[0].trailing_adapter_bases
        signal_len = end - start
        split_range = (-1, -1)
        if len(info) > 1:
            s2, e2 = self.determine_signal_bounds(
                info[1].signal_anchor, info[1].search_dir, read, spb, std
            )
            split_range = (s2, e2)
            if start <= s2 <= end:
                signal_len = start - e2
            elif s2 <= start <= e2:
                signal_len = s2 - end
            elif s2 <= start and end <= e2:
                signal_len = e2 - s2
            elif start <= s2 and e2 <= end:
                signal_len = end - start
            else:
                signal_len = (end - start) + (e2 - s2)
            trailing += info[1].trailing_adapter_bases
        if self.offset is not None:
            offset_cal = self.offset
        else:
            offset_cal = 0.0
            signal_len -= self.signal_length_adjustment(read, signal_len)
        signal_len = max(0, signal_len)
        num_bases = int(round(signal_len / spb - trailing - offset_cal))
        if split_range != (-1, -1):
            split_range = (
                split_range[0] + read.num_trimmed_samples,
                split_range[1] + read.num_trimmed_samples,
            )
        return PolyTailResult(
            num_bases=num_bases,
            # PolyACalculatorNode.cpp:61-64: anchor reported in original
            # (untrimmed) signal coordinates
            signal_anchor=info[0].signal_anchor + read.num_trimmed_samples,
            signal_range=(start + read.num_trimmed_samples, end + read.num_trimmed_samples),
            split_signal_range=split_range,
        )


class DNAPolyTailCalculator(PolyTailCalculator):
    def determine_signal_anchor_and_strand(self, read: ReadContext) -> list[SignalAnchorInfo]:
        cfg = self.config
        trailing_ts = len(cfg.rear_primer) - len(cfg.rear_primer.rstrip("T"))
        front = cfg.front_primer
        front_rc = cfg.rc_front_primer
        rear = cfg.rear_primer[: len(cfg.rear_primer) - trailing_ts]
        rear_rc = cfg.rc_rear_primer[trailing_ts:]

        seq = read.seq
        read_top = seq[: cfg.primer_window]
        bottom_start = max(0, len(seq) - cfg.primer_window)
        read_bottom = seq[bottom_start:]

        top_v1 = align(front, read_top, mode=MODE_HW)
        bottom_v1 = align(rear_rc, read_bottom, mode=MODE_HW)
        dist_v1 = top_v1.distance + bottom_v1.distance

        top_v2 = align(rear, read_top, mode=MODE_HW)
        bottom_v2 = align(front_rc, read_bottom, mode=MODE_HW)
        dist_v2 = top_v2.distance + bottom_v2.distance

        fwd = dist_v1 < dist_v2
        flank_score = 1.0 - min(dist_v1, dist_v2) / (len(front) + len(rear))
        if flank_score < cfg.flank_threshold or abs(dist_v1 - dist_v2) <= cfg.min_primer_separation:
            return []

        if fwd:
            base_anchor = bottom_start + bottom_v1.t_start
            direction = BACKWARD
        else:
            base_anchor = top_v2.t_end - 1
            direction = FORWARD
        m = self._seq_to_sig_map(read)
        return [SignalAnchorInfo(direction, int(m[base_anchor]), trailing_ts)]

    def average_samples_per_base(self, sizes: np.ndarray) -> float:
        return float(_quantiles(sizes, [0.5])[0])

    def signal_length_adjustment(self, read: ReadContext, signal_len: int) -> int:
        is_prom = "PRO" in read.flow_cell_product_code
        return 0 if is_prom else int(round(signal_len * 0.063))

    def min_avg_val(self) -> float:
        return -3.0


class PlasmidPolyTailCalculator(DNAPolyTailCalculator):
    """Plasmid tails: both flanks searched anywhere in the read, with
    split-tail (two-anchor) support when the tail spans the linearisation
    junction (plasmid_poly_tail_calculator.cpp:22-120). The config's
    front/rear primers hold the plasmid flanks (poly_tail_config.cpp)."""

    def determine_signal_anchor_and_strand(self, read: ReadContext) -> list[SignalAnchorInfo]:
        cfg = self.config
        front_flank = cfg.front_primer
        rear_flank = cfg.rear_primer
        front_flank_rc = cfg.rc_front_primer
        rear_flank_rc = cfg.rc_rear_primer
        threshold = cfg.flank_threshold
        seq = read.seq

        def align_query(query: str):
            """(score, start, end_incl); locations only when score passes."""
            if not query:
                return (-1.0, -1, -1)
            res = align(query, seq, mode=MODE_HW)
            score = 1.0 - res.distance / len(query)
            if score >= threshold:
                return (score, res.t_start, res.t_end - 1)
            return (score, -1, -1)

        fwd_front = align_query(front_flank)
        fwd_rear = align_query(rear_flank)
        rev_front = align_query(rear_flank_rc)
        rev_rear = align_query(front_flank_rc)

        scores = [fwd_front[0], fwd_rear[0], rev_front[0], rev_rear[0]]
        fwd = int(np.argmax(scores)) < 2

        front_result = fwd_front if fwd else rev_front
        rear_result = fwd_rear if fwd else rev_rear
        # front and rear good but out of order indicates a cleaved tail
        split_tail = (
            front_result[0] >= threshold
            and rear_result[0] >= threshold
            and rear_result[2] < front_result[1]
        )

        m = self._seq_to_sig_map(read)
        info: list[SignalAnchorInfo] = []
        if fwd:
            if fwd_front[0] >= threshold:
                trailing = len(front_flank) - len(front_flank.rstrip("A"))
                info.append(SignalAnchorInfo(FORWARD, int(m[front_result[2]]), trailing))
            if (split_tail or not info) and fwd_rear[0] >= threshold:
                trailing = len(rear_flank) - len(rear_flank.lstrip("A"))
                info.append(SignalAnchorInfo(BACKWARD, int(m[rear_result[1]]), trailing))
        else:
            if rev_front[0] >= threshold:
                trailing = len(rear_flank_rc) - len(rear_flank_rc.rstrip("T"))
                info.append(SignalAnchorInfo(FORWARD, int(m[front_result[2]]), trailing))
            if (split_tail or not info) and rev_rear[0] >= threshold:
                trailing = len(front_flank_rc) - len(front_flank_rc.lstrip("T"))
                info.append(SignalAnchorInfo(BACKWARD, int(m[rear_result[1]]), trailing))
        return info


class RNAPolyTailCalculator(PolyTailCalculator):
    def __init__(self, config, rna_adapter: bool = False, speed=None, offset=None):
        super().__init__(config, speed, offset)
        self.rna_adapter = rna_adapter

    def determine_signal_anchor_and_strand(self, read: ReadContext) -> list[SignalAnchorInfo]:
        cfg = self.config
        if not self.rna_adapter:
            return [SignalAnchorInfo(FORWARD, read.rna_adapter_end_signal_pos, 0)]
        seq = read.seq
        bottom_start = max(0, len(seq) - cfg.primer_window)
        read_bottom = seq[bottom_start:]
        res = align(cfg.rna_adapter, read_bottom, mode=MODE_HW)
        score = 1.0 - res.distance / len(cfg.rna_adapter)
        if score < cfg.flank_threshold:
            return []
        m = self._seq_to_sig_map(read)
        base_anchor = bottom_start + res.t_start
        # RNA sequence is reversed wrt the signal and move table
        signal_anchor = int(m[len(seq) - base_anchor])
        return [SignalAnchorInfo(FORWARD, signal_anchor, 0)]

    def average_samples_per_base(self, sizes: np.ndarray) -> float:
        sizes = np.asarray(sizes, dtype=np.float64)
        if sizes.size == 0:
            return 0.0
        geo = float(np.exp(np.log(np.maximum(sizes, 1e-9)).mean()))
        q10, q90 = _quantiles(sizes, [0.1, 0.9])
        sel = (sizes >= q10) & (sizes <= q90)
        trimmed = float(sizes[sel].mean()) if sel.any() else 0.0
        return (geo + trimmed) / 2.0

    def signal_length_adjustment(self, read: ReadContext, signal_len: int) -> int:
        return int(round(min(100.0, np.exp(5.6838 - 0.0021 * signal_len))))

    def min_avg_val(self) -> float:
        return -0.5

    def buffer_range(self, interval, samples_per_base):
        span = interval[1] - interval[0]
        if self.rna_adapter:
            return span + int(round(self.config.rna_offset * samples_per_base)), span
        return span, span


def make_calculator(
    config: PolyTailConfig | None = None,
    is_rna: bool = False,
    is_rna_adapter: bool = False,
    speed: float | None = None,
    offset: float | None = None,
) -> PolyTailCalculator:
    config = config or PolyTailConfig()
    if is_rna:
        return RNAPolyTailCalculator(config, is_rna_adapter, speed, offset)
    if config.is_plasmid:
        return PlasmidPolyTailCalculator(config, speed, offset)
    return DNAPolyTailCalculator(config, speed, offset)


class PolyTailCalculatorSelector:
    """Per-barcode calculator selection (poly_tail_calculator_selector.cpp:46-82).

    Keys are full barcode ids like "SQK-PCB114-24_barcode01" (the read's
    classified barcode string, PolyACalculatorNode.cpp:46). When any
    barcode-specific overrides exist, unclassified reads get NO calculator —
    better no result than a wrong one (selector :63-65). A config with
    [status] enabled=false also yields None.
    """

    def __init__(
        self,
        configs: dict | PolyTailConfig | None = None,
        is_rna: bool = False,
        is_rna_adapter: bool = False,
        speed: float | None = None,
        offset: float | None = None,
    ):
        if configs is None or isinstance(configs, PolyTailConfig):
            configs = {"": configs}

        def mk(cfg):
            return make_calculator(cfg, is_rna, is_rna_adapter, speed, offset)

        self._default = mk(configs.get(""))
        self._lut = {k: mk(cfg) for k, cfg in configs.items() if k}

    def get_calculator(self, barcode: str | None = None) -> PolyTailCalculator | None:
        if barcode in self._lut:
            calc = self._lut[barcode]
        elif barcode == UNCLASSIFIED and self._lut:
            return None
        else:
            calc = self._default
        return calc if calc.config.enabled else None


def load_poly_tail_config(path) -> PolyTailConfig:
    """Parse a --poly-a-config TOML; returns the default (non-barcode)
    config. Use `load_poly_tail_configs` for per-barcode overrides."""
    return load_poly_tail_configs(path)[""]


def load_poly_tail_configs(path) -> dict:
    """Parse a --poly-a-config TOML (poly_tail/poly_tail_config.cpp:20-127):
    [anchors] front/rear primers or plasmid flanks + windows, [threshold]
    flank_threshold, [tail] tail_interrupt_length, plus per-barcode
    [[overrides]] tables. Returns {barcode_id: config}; "" is the default."""
    with open(path, "rb") as fh:
        raw = tomllib.load(fh)
    default = _update_config(raw, PolyTailConfig())
    if raw.get("barcode_id"):
        raise ValueError("Default poly tail config must not specify barcode_id.")
    configs = {"": default}
    ids = set()
    for override in raw.get("overrides", []):
        bc = override.get("barcode_id", "")
        if not bc:
            raise ValueError("Missing barcode_id in override poly tail configuration.")
        if bc in ids:
            raise ValueError("Duplicate barcode_id found in poly tail config file.")
        ids.add(bc)
        configs[bc] = _update_config(override, copy.deepcopy(default))
    return configs


def _update_config(raw: dict, cfg: PolyTailConfig) -> PolyTailConfig:
    anchors = raw.get("anchors", {})
    has_primers = "front_primer" in anchors or "rear_primer" in anchors
    if has_primers:
        if not ("front_primer" in anchors and "rear_primer" in anchors):
            raise ValueError("Both front_primer and rear_primer must be provided")
        cfg.front_primer = anchors["front_primer"]
        cfg.rear_primer = anchors["rear_primer"]
    if "plasmid_front_flank" in anchors or "plasmid_rear_flank" in anchors:
        if has_primers:
            raise ValueError("Both primer and plasmid anchors specified")
        if not (
            "plasmid_front_flank" in anchors and "plasmid_rear_flank" in anchors
        ):
            raise ValueError("Both plasmid flanks must be provided")
        cfg.front_primer = anchors["plasmid_front_flank"]
        cfg.rear_primer = anchors["plasmid_rear_flank"]
        cfg.is_plasmid = True
        cfg.flank_threshold = 0.85
    if "primer_window" in anchors:
        cfg.primer_window = int(anchors["primer_window"])
        if cfg.primer_window <= 0:
            raise ValueError("primer_window size needs to be > 0")
    if "min_primer_separation" in anchors:
        cfg.min_primer_separation = int(anchors["min_primer_separation"])
        if cfg.min_primer_separation <= 0:
            raise ValueError("min_primer_separation size needs to be > 0")
    threshold = raw.get("threshold", {})
    if "flank_threshold" in threshold:
        cfg.flank_threshold = float(threshold["flank_threshold"])
    tail = raw.get("tail", {})
    if "tail_interrupt_length" in tail:
        cfg.tail_interrupt_length = int(tail["tail_interrupt_length"])
    status = raw.get("status", {})
    if "enabled" in status:
        cfg.enabled = bool(status["enabled"])
    return cfg
