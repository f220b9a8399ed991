"""Unit-cost edit-distance alignment with traceback, for the read splitter,
the barcode classifier, the adapter and primer finders and the poly(A)
anchors.

Port of ``align`` of the JAX package's native module over the port's own
copy of its C++ source, ``csrc/align.cpp``, which ``g++`` builds at first use into
``csrc/build/`` (a file name that carries a hash of the source and flags) and
``ctypes`` loads. ``ctypes`` releases the interpreter lock for the call, so
the pipeline's finish threads align in parallel. A failed build raises:
there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "align.cpp"
BUILD_DIR = CSRC / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

EDOP_MATCH = 0
EDOP_INSERT = 1  # query-consumed-only (insertion to target)
EDOP_DELETE = 2  # target-consumed-only (deletion from target)
EDOP_MISMATCH = 3

MODE_NW = 0  # global
MODE_HW = 1  # infix (free gaps at target start+end)
MODE_SHW = 2  # prefix (free gap at target end)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def host_library_path(source: Path) -> Path:
    """``csrc/build/<stem>-<hash>.so``: the hash of a host C++ source and
    the flags that build it."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:12]}.so"


def build_host_library(source: Path, path: Path) -> Path:
    """Compile the host C++ ``source`` into ``path`` unless it exists; raise
    with the compiler's output if the build fails."""
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {source.name} (exit {res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent builder finds a whole file
    return path


def library_path() -> Path:
    return host_library_path(SOURCE)


def build() -> Path:
    """Compile ``csrc/align.cpp`` unless its library exists; raise with the
    compiler's output if the build fails."""
    return build_host_library(SOURCE, library_path())


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.dt_align.restype = ctypes.c_int
            lib.dt_align.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, i32p, i32p, i32p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                i32p, i32p, ctypes.c_char_p,
            ]
            _lib = lib
        return _lib


def make_equality_table(pairs: list[tuple[str, str]]) -> bytes:
    """256x256 symmetric extra-equality table for wildcard matching
    (edlib additionalEqualities semantics)."""
    table = bytearray(256 * 256)
    for a, b in pairs:
        table[ord(a) * 256 + ord(b)] = 1
        table[ord(b) * 256 + ord(a)] = 1
    return bytes(table)


# edlib config of the barcode classifier (BarcodeClassifier.cpp:28-38):
# N matches any base (the barcode mask), M matches A/C (16S wobble base)
BARCODE_EQUALITIES = [
    ("N", "A"),
    ("N", "T"),
    ("N", "C"),
    ("N", "G"),
    ("N", "U"),
    ("M", "A"),
    ("M", "C"),
]


@dataclass
class AlignResult:
    distance: int
    t_start: int
    t_end: int  # exclusive
    ops: np.ndarray  # uint8 edlib-style op codes, query-start -> query-end


def align(
    query: str | bytes,
    target: str | bytes,
    mode: int = MODE_NW,
    equalities: bytes | None = None,
) -> AlignResult:
    """Unit-cost edit-distance alignment with traceback.

    The band widens fourfold until the result is provably unclipped (banded
    DP with edge detection) or spans the longer sequence, so results match
    full DP; where several optima tie, the band decides which is returned.
    ``equalities`` is a ``make_equality_table`` of base pairs that also
    match."""
    if equalities is not None and len(equalities) != 256 * 256:
        raise ValueError("equalities must be a 256 x 256 table")
    q = query.encode() if isinstance(query, str) else bytes(query)
    t = target.encode() if isinstance(target, str) else bytes(target)
    lib = _get_lib()

    cap = len(q) + len(t) + 2
    ops_buf = (ctypes.c_uint8 * cap)()
    dist = ctypes.c_int32()
    t_start = ctypes.c_int32()
    t_end = ctypes.c_int32()
    ops_len = ctypes.c_int32()
    band_hit = ctypes.c_int32()

    b = max(32, abs(len(q) - len(t)) + 32)
    max_band = max(len(q), len(t), 1)
    while True:
        rc = lib.dt_align(q, len(q), t, len(t), mode, b, ctypes.byref(dist),
                          ctypes.byref(t_start), ctypes.byref(t_end), ops_buf, cap,
                          ctypes.byref(ops_len), ctypes.byref(band_hit), equalities)
        if rc != 0:
            raise RuntimeError(f"dt_align failed with code {rc}")
        if (band_hit.value == 0 and dist.value >= 0) or b >= max_band:
            break
        b = min(max_band, b * 4)

    ops = np.frombuffer(bytes(ops_buf[: ops_len.value]), dtype=np.uint8).copy()
    return AlignResult(distance=int(dist.value), t_start=int(t_start.value),
                       t_end=int(t_end.value), ops=ops)
