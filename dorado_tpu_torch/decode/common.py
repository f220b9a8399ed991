"""Shared decode types."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DecoderOptions:
    beam_width: int = 32
    beam_cut: float = 100.0
    blank_score: float = 2.0
    q_shift: float = 0.0
    q_scale: float = 1.0


@dataclass
class DecodedChunk:
    sequence: str
    qstring: str
    moves: np.ndarray  # uint8 [T]
