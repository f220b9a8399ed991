"""Colinear anchor chaining for the read mapper (``alignment/mapper.py``).

Port of the JAX package's ``chain_native`` over the port's own copy of its
C++ source, ``csrc/chain.cpp``, which ``g++`` builds at first use into
``csrc/build/`` (a file name that carries a hash of the source and flags),
as ``utils/align.py`` builds ``csrc/align.cpp``, and ``ctypes`` loads. A
failed build raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from dorado_tpu_torch.utils.align import CSRC, build_host_library, host_library_path

SOURCE = CSRC / "chain.cpp"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    return host_library_path(SOURCE)


def build() -> Path:
    """Compile ``csrc/chain.cpp`` unless its library exists; raise with the
    compiler's output if the build fails."""
    return build_host_library(SOURCE, library_path())


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
            lib.dt_chain.restype = ctypes.c_int
            lib.dt_chain.argtypes = [
                i64p, i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS"),
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        return _lib


def chain(
    q_pos: np.ndarray, r_pos: np.ndarray, k: int, max_gap: int = 5000, lookback: int = 50
) -> tuple[np.ndarray, float]:
    """Best colinear chain over anchors sorted by (r, q): (indices into the
    sorted order, score)."""
    lib = _get_lib()
    q = np.ascontiguousarray(q_pos, dtype=np.int64)
    r = np.ascontiguousarray(r_pos, dtype=np.int64)
    n = len(q)
    out = np.zeros(max(1, n), dtype=np.int32)
    score = ctypes.c_double()
    length = lib.dt_chain(q, r, n, k, max_gap, lookback, out, ctypes.byref(score))
    return out[:length], float(score.value)
