"""Signal start-trim heuristic (parity: dorado/torch_utils/trim.cpp:21-56).

Scans fixed windows of the scaled signal for a run of above-threshold samples
("the adapter peak"); the read is trimmed at the end of the first window after
the peak subsides.
"""

from __future__ import annotations

import numpy as np

DEFAULT_TRIM_THRESHOLD = 2.4
DEFAULT_TRIM_WINDOW_SIZE = 40
DEFAULT_TRIM_MIN_ELEMENTS = 3


def trim_signal(
    signal: np.ndarray,
    threshold: float = DEFAULT_TRIM_THRESHOLD,
    window_size: int = DEFAULT_TRIM_WINDOW_SIZE,
    min_elements: int = DEFAULT_TRIM_MIN_ELEMENTS,
) -> int:
    """Number of samples to trim from the start of ``signal``."""
    min_trim = 10
    num_samples = len(signal) - min_trim
    num_windows = num_samples // window_size
    sig = np.asarray(signal, dtype=np.float32)

    seen_peak = False
    for pos in range(num_windows):
        start = pos * window_size + min_trim
        end = start + window_size
        num_large_enough = int(np.count_nonzero(sig[start:end] > threshold))
        if num_large_enough > min_elements or seen_peak:
            seen_peak = True
            if sig[end - 1] > threshold:
                continue
            if end >= num_samples:
                return min_trim
            return end
    return min_trim
