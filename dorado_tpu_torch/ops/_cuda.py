"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, then loaded with ``ctypes``. A
library's file name carries a hash of its sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused. Nothing is built or loaded
when this module is imported: the first launch of a kernel builds it, and
``build_kernels()`` builds every kernel at once, one ``nvcc`` per source, all
running together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNEL_SOURCES = (
    "lstm_scan", "w8a8_matmul_fq", "crf_lse_backward", "crf_fused_forward", "crf_traceback",
    "crf_lse_scan", "beam_search", "attention_banded", "w8a8_matmul", "fused_norm",
    "crf_viterbi_forward",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    # every header: a kernel source may include any of them
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_kernels(names=KERNEL_SOURCES) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, all in parallel.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``<library>.log``. Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    jobs = []
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".so.log"), "wb")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log,
            stderr=subprocess.STDOUT,
        )
        jobs.append((name, path, tmp, log, proc))
    failed = []
    for name, path, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{name}: nvcc exit {rc}\n" + path.with_suffix(".so.log").read_text())
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def kernel_function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name``, built on
    first use. Every entry point returns a ``cudaError_t`` as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_kernels([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.dtt_error_string.argtypes = [ctypes.c_int]
            lib.dtt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = _libs[name].dtt_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")


def check_tensor(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple) -> None:
    """Validate a kernel argument: CUDA device, dtype, shape, contiguity and
    16-byte alignment (the kernels load rows as 8- and 16-byte vectors)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: expected a 16-byte aligned tensor")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, symbol: str, argtypes: list, device: torch.device, *args,
           stream: bool = True) -> None:
    """Call the C entry point ``symbol`` of kernel library ``name`` with
    ``args`` (and then, with ``stream``, ``device``'s current stream) while
    ``device`` is the current CUDA device, and raise if it returned an error.

    Every kernel wrapper launches through here. The C launchers act on the
    calling thread's current device (``cudaFuncSetAttribute``, the occupancy
    queries behind a persistent grid), so that device must be the tensors'
    card: on a machine with several cards, a launch for card 1 made while
    card 0 is current would set the attributes of the wrong card."""
    fn = kernel_function(name, symbol, [*argtypes, VOIDP] if stream else list(argtypes))
    with torch.cuda.device(device):
        code = fn(*args, stream_ptr(device)) if stream else fn(*args)
    check_launch(name, code)


VOIDP = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
DOUBLE = ctypes.c_double
