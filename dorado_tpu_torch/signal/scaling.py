"""Raw-signal normalisation (shift/scale) ahead of basecalling.

Three strategies, selected by the model config (quantile / med_mad / pA
standardisation), with formulas matching the reference node
(dorado/read_pipeline/nodes/ScalerNode.cpp:33-52,195-230) so that downstream
calls are comparable. Scaled output is ``(x - shift) / scale`` in all modes.

The RNA adapter-position detector mirrors
ScalerNode.cpp:59-116 (sliding-window medians over raw int16 signal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dorado_tpu_torch.config import ScalingStrategy, SignalNormalisationParams

_EPS = 1e-9

# Expected open-pore levels per flowcell product family
# (reference: ScalerNode.cpp:118-134).
_PORE_LEVEL_KIT14_PROM = 199.21
_PORE_LEVEL_KIT14_MIN = 197.61
_PORE_LEVEL_RNA004_PROM = 194.97
_PORE_LEVEL_RNA004_MIN = 195.50
_PORE_LEVEL_FLONGLE = 200.0

_FLOWCELL_PORE_LEVELS = {
    "FLO-FLG114": _PORE_LEVEL_FLONGLE,
    "FLO-FLG114HD": _PORE_LEVEL_FLONGLE,
    "FLO-MIN004RA": _PORE_LEVEL_RNA004_MIN,
    "FLO-PRO004RA": _PORE_LEVEL_RNA004_PROM,
    "FLO-MIN114": _PORE_LEVEL_KIT14_MIN,
    "FLO-MIN114HD": _PORE_LEVEL_KIT14_MIN,
    "FLO-PRO114": _PORE_LEVEL_KIT14_PROM,
    "FLO-PRO114HD": _PORE_LEVEL_KIT14_PROM,
    "FLO-PRO114M": _PORE_LEVEL_KIT14_PROM,
}


@dataclass
class ScalingResult:
    shift: float
    scale: float


def med_mad(x: np.ndarray) -> ScalingResult:
    """Median / scaled median-absolute-deviation estimate of shift/scale."""
    factor = 1.4826
    med = float(np.median(x))
    mad = float(np.median(np.abs(x.astype(np.float32) - med))) * factor + _EPS
    return ScalingResult(shift=med, scale=mad)


def quantile_counting(x: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Counting-sort quantiles over int16 data.

    Index semantics match torch_utils/tensor_utils.cpp:217-245: the result for
    quantile q is the smallest value v with cumulative count > q*(n-1).
    """
    x = np.asarray(x)
    sorted_x = np.sort(x, kind="stable")
    n = x.size
    idx = (np.asarray(qs, dtype=np.float32) * (n - 1)).astype(np.int64)
    return sorted_x[idx].astype(np.float32)


def quantile_scaling(
    x: np.ndarray, params: SignalNormalisationParams
) -> ScalingResult:
    q = params.quantile
    qa, qb = quantile_counting(
        x, np.array([q.quantile_a, q.quantile_b], dtype=np.float32)
    )
    shift = max(10.0, q.shift_multiplier * (float(qa) + float(qb)))
    scale = max(1.0, q.scale_multiplier * (float(qb) - float(qa)))
    return ScalingResult(shift=shift, scale=scale)


def pa_scaling(
    params: SignalNormalisationParams,
    read_scale: float,
    read_offset: float,
) -> ScalingResult:
    """Calibration-based picoampere standardisation.

    The POD5 calibration maps raw ADC to pA via ``pA = scale*(x + offset)``;
    composing with optional standardisation keeps the downstream formula
    ``(x - shift)/scale`` (ScalerNode.cpp:195-213).
    """
    stdn = params.standardisation
    if stdn.standardise:
        scale = stdn.stdev / read_scale
        shift = (stdn.mean / read_scale) - read_offset
    else:
        scale = 1.0 / read_scale
        shift = -read_offset
    return ScalingResult(shift=shift, scale=scale)


def open_pore_adjustment(
    open_pore_level: float, flow_cell_product_code: str, read_scale: float
) -> float:
    """Shift adjustment when the observed open-pore level differs from the
    flowcell's expected level (pA strategy only)."""
    if open_pore_level is None or np.isnan(open_pore_level):
        return 0.0
    expected = _FLOWCELL_PORE_LEVELS.get(flow_cell_product_code.upper().replace("_", "-"))
    if not expected:
        return 0.0
    return (open_pore_level - expected) / read_scale


def determine_rna_adapter_pos(signal: np.ndarray) -> int:
    """Approximate end of the DNA adapter in a direct-RNA read, found by
    watching for a jump in sliding-window signal medians."""
    window, stride = 250, 50
    median_diff = 125
    median_diff_only = 150
    min_median_rna = 700

    n = len(signal)
    medians = np.zeros(5, dtype=np.int16)
    window_pos = np.zeros(5, dtype=np.int64)
    median_idx = 0
    start, end = 1000, 3 * n // 4
    for i in range(start, end, stride):
        win = signal[i : i + window]
        med = np.int16(np.median(win))
        slot = median_idx % 5
        medians[slot] = med
        window_pos[slot] = median_idx
        min_slot = int(np.argmin(medians))
        max_slot = int(np.argmax(medians))
        lo, hi = int(medians[min_slot]), int(medians[max_slot])
        if (
            median_idx >= 5
            and window_pos[max_slot] > window_pos[min_slot]
            and ((hi > min_median_rna and hi - lo > median_diff) or hi - lo > median_diff_only)
        ):
            return i
        median_idx += 1
    return 0


class Scaler:
    """Per-read scaler: int16 raw signal -> normalised float32 array."""

    def __init__(self, params: SignalNormalisationParams, is_rna: bool = False):
        self.params = params
        self.is_rna = is_rna

    def scale_read(
        self,
        signal: np.ndarray,
        read_scale: float = 1.0,
        read_offset: float = 0.0,
        open_pore_level: float = float("nan"),
        flow_cell_product_code: str = "",
    ) -> tuple[np.ndarray, int, ScalingResult]:
        """Returns (scaled float32 signal, trimmed-sample count, shift/scale)."""
        trim_start = 0
        if self.is_rna:
            # the adapter's end lies below 3/4 of the read, so it never
            # trims the whole signal
            trim_start = determine_rna_adapter_pos(signal)
            signal = signal[trim_start:]

        strategy = self.params.strategy
        adjustment = 0.0
        if strategy is ScalingStrategy.PA:
            result = pa_scaling(self.params, read_scale, read_offset)
            # applied to the signal but NOT reported in the sm/sd tags
            # (ScalerNode.cpp:228-234)
            adjustment = open_pore_adjustment(
                open_pore_level, flow_cell_product_code, read_scale
            )
        else:
            if strategy is ScalingStrategy.QUANTILE:
                result = quantile_scaling(signal, self.params)
            else:
                result = med_mad(signal)

        scaled = (signal.astype(np.float32) - (result.shift + adjustment)) / result.scale
        return scaled, trim_start, result
