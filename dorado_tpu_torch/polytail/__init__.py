"""Poly(A)/poly(T) tail length estimation (port of ``dorado_tpu/polytail``)."""

from dorado_tpu_torch.polytail.calculator import (
    DNAPolyTailCalculator,
    PolyTailCalculatorSelector,
    PolyTailConfig,
    RNAPolyTailCalculator,
    load_poly_tail_config,
    load_poly_tail_configs,
    make_calculator,
)

__all__ = [
    "DNAPolyTailCalculator",
    "PolyTailCalculatorSelector",
    "PolyTailConfig",
    "RNAPolyTailCalculator",
    "load_poly_tail_config",
    "load_poly_tail_configs",
    "make_calculator",
]
