"""Raw-signal normalisation (shift/scale) ahead of basecalling.

Three strategies, selected by the model config (quantile / med_mad / pA
standardisation), with formulas matching the reference node
(dorado/read_pipeline/nodes/ScalerNode.cpp:33-52,195-230) so that downstream
calls are comparable. Scaled output is ``(x - shift) / scale`` in all modes.
DNA only: the RNA adapter trim of the JAX package is not ported yet.
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


class Scaler:
    """Per-read scaler: int16 raw signal -> normalised float32 array."""

    def __init__(self, params: SignalNormalisationParams):
        self.params = params

    def scale_read(
        self,
        signal: np.ndarray,
        read_scale: float = 1.0,
        read_offset: float = 0.0,
        open_pore_level: float = float("nan"),
        flow_cell_product_code: str = "",
    ) -> tuple[np.ndarray, ScalingResult]:
        """Returns (scaled float32 signal, shift/scale)."""
        strategy = self.params.strategy
        adjustment = 0.0
        if strategy is ScalingStrategy.PA:
            result = pa_scaling(self.params, read_scale, read_offset)
            # applied to the signal but NOT reported in the sm/sd tags
            # (ScalerNode.cpp:228-234)
            adjustment = open_pore_adjustment(
                open_pore_level, flow_cell_product_code, read_scale
            )
        elif strategy is ScalingStrategy.QUANTILE:
            result = quantile_scaling(signal, self.params)
        else:
            result = med_mad(signal)

        scaled = (signal.astype(np.float32) - (result.shift + adjustment)) / result.scale
        return scaled, result
