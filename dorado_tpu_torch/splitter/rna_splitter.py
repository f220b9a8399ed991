"""RNA read splitting (signal-space only, pre-basecall).

Port of ``dorado_tpu/splitter/rna_splitter.py`` (dorado/splitter/
RNAReadSplitter.cpp): split raw int16 signal at open-pore spike clusters."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dorado_tpu_torch.splitter.utils import detect_pore_signal


@dataclass
class RNASplitSettings:
    pore_thr: int = 1500
    pore_cl_dist: int = 2000
    expect_pore_prefix: int = 2000


class RNAReadSplitter:
    def __init__(self, settings: RNASplitSettings | None = None):
        self.settings = settings or RNASplitSettings()

    def split(self, signal: np.ndarray) -> list[tuple[int, int]]:
        """Raw int16 signal -> list of [start, end) subread sample ranges."""
        s = self.settings
        spacers = detect_pore_signal(
            signal, s.pore_thr, s.pore_cl_dist, s.expect_pore_prefix
        )
        if not spacers:
            return [(0, len(signal))]
        out = []
        start = 0
        for r in spacers:
            if start < r.start_sample:
                out.append((start, r.start_sample))
            start = r.end_sample
        if start < len(signal):
            out.append((start, len(signal)))
        return out
