"""Sequence-space utilities (parity: dorado/utils/sequence_utils.cpp)."""

from __future__ import annotations

import numpy as np

_CHAR_TO_ERR = 10.0 ** (-(np.arange(256, dtype=np.float32) - 33.0) / 10.0)
_CHAR_TO_ERR[:33] = 0.0


def mean_qscore_from_qstring(qstring: str | bytes) -> float:
    """Mean qscore in probability space, clamped to [1, 50]
    (sequence_utils.cpp `mean_qscore_from_qstring`)."""
    if not qstring:
        return 0.0
    q = np.frombuffer(
        qstring.encode() if isinstance(qstring, str) else qstring, dtype=np.uint8
    )
    mean_error = float(np.mean(_CHAR_TO_ERR[q], dtype=np.float64))
    mean_q = -10.0 * np.log10(mean_error)
    return float(np.clip(mean_q, 1.0, 50.0))


def find_rna_polya(seq: str) -> int:
    """Index of the polyA start near the (reversed-RNA) read end; len(seq) if
    none found (sequence_utils.cpp `find_rna_polya`)."""
    search_size = 200
    min_polya_size = 5
    size = len(seq)
    end = size - search_size if search_size < size else 0
    polya_size = 0
    polya_end_idx = size
    for i in range(size, end, -1):
        if seq[i - 1] == "A":
            polya_size += 1
            if polya_size >= min_polya_size:
                polya_end_idx = i - 1
        elif polya_end_idx != size:
            break
        else:
            polya_size = 0
    return polya_end_idx


_COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgtNn", b"TGCATGCANN"):
    _COMPLEMENT[_a] = _b


def reverse_complement(seq: str) -> str:
    arr = np.frombuffer(seq.encode(), dtype=np.uint8)
    return _COMPLEMENT[arr[::-1]].tobytes().decode()
