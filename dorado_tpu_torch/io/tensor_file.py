"""Reader and writer for dorado ``.tensor`` weight files.

Port of ``dorado_tpu/io/tensor_file.py``. Each weight of a dorado model
directory is a TorchScript zip archive (dorado/torch_utils/
tensor_utils.cpp:147-165)::

    <name>/data.pkl           pickle of a __torch__.Module whose parameters
                              ("0", "1", ...) are the tensors
    <name>/data/<key>         raw little-endian storage bytes per tensor
    <name>/code/__torch__.py  TorchScript source stub (ignored)
    <name>/constants.pkl      empty tuple
    <name>/version            archive version

The pickle is parsed by a restricted unpickler that knows only the tensor
rebuild function, the storage types and the module class, so a weight file
can run no code; ``torch.load`` is not used (the archives the JAX package
writes hold no TorchScript code it would accept). Tensors come back as CPU
``torch.Tensor``s, bf16 storage as ``torch.bfloat16``.
"""

from __future__ import annotations

import io
import pickle
import struct
import zipfile
from pathlib import Path

import numpy as np
import torch

# torch storage class name -> dtype
_STORAGE_DTYPES = {
    "DoubleStorage": torch.float64,
    "FloatStorage": torch.float32,
    "HalfStorage": torch.float16,
    "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64,
    "IntStorage": torch.int32,
    "ShortStorage": torch.int16,
    "CharStorage": torch.int8,
    "ByteStorage": torch.uint8,
    "BoolStorage": torch.bool,
}
_DTYPE_TO_STORAGE = {v: k for k, v in _STORAGE_DTYPES.items()}


class _Storage:
    """Stand-in for a torch typed storage: dtype + archive data key."""

    def __init__(self, dtype: torch.dtype, key: str, numel: int):
        self.dtype = dtype
        self.key = key
        self.numel = numel


class _StorageType:
    """What the unpickler returns for ``torch.<Name>Storage``."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype


class _Module(dict):
    """Stand-in for __torch__.Module: collects its parameter dict."""

    def __setstate__(self, state):
        self.update(state)


class _OrderedDictStandin(dict):
    pass


def _rebuild_tensor_v2(storage, storage_offset, size, stride, *_args):
    return ("tensor", storage, storage_offset, tuple(size), tuple(stride))


class _TensorUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "torch._utils" and name.startswith("_rebuild_tensor"):
            return _rebuild_tensor_v2
        if module == "torch" and name in _STORAGE_DTYPES:
            return _StorageType(_STORAGE_DTYPES[name])
        if module.startswith("__torch__") or name == "Module":
            # the TorchScript class path varies with the saving module's name
            return _Module
        if module == "collections" and name == "OrderedDict":
            return _OrderedDictStandin
        raise pickle.UnpicklingError(f"unsupported global {module}.{name}")

    def persistent_load(self, pid):
        kind, storage_type, key, _device, numel = pid
        if kind != "storage" or not isinstance(storage_type, _StorageType):
            raise pickle.UnpicklingError(f"unsupported persistent id {pid!r}")
        return _Storage(storage_type.dtype, str(key), int(numel))


def _materialise(archive: zipfile.ZipFile, root: str, obj) -> torch.Tensor:
    _tag, storage, offset, size, stride = obj
    raw = archive.read(f"{root}/data/{storage.key}")
    itemsize = torch.empty(0, dtype=storage.dtype).element_size()
    if len(raw) < storage.numel * itemsize:
        raise ValueError(f"tensor storage {storage.key!r}: {len(raw)} bytes, "
                         f"expected {storage.numel * itemsize}")
    # a writable copy: torch.frombuffer warns on read-only bytes
    flat = torch.frombuffer(bytearray(raw), dtype=storage.dtype, count=storage.numel)
    if not size:
        return flat[offset].clone()
    return torch.as_strided(flat, size, stride, offset).contiguous()


def load_tensor_file(path: Path | str) -> list[torch.Tensor]:
    """Load every tensor in a ``.tensor`` archive, in parameter-name order."""
    path = Path(path)
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        pkl = next((n for n in names if n.endswith("/data.pkl")), None)
        if pkl is None:
            raise ValueError(f"{path}: no data.pkl in the archive")
        root = pkl[: -len("/data.pkl")]
        module = _TensorUnpickler(io.BytesIO(z.read(pkl))).load()
        # numeric keys are the saved parameters; jit-scripted modules also
        # carry attributes like "training": ignore those
        items = sorted(
            ((k, v) for k, v in module.items() if str(k).isdigit()),
            key=lambda kv: int(kv[0]),
        )
        return [_materialise(z, root, v) for _, v in items]


def load_tensor(path: Path | str) -> torch.Tensor:
    """Load a single-tensor ``.tensor`` archive."""
    tensors = load_tensor_file(path)
    if len(tensors) != 1:
        raise ValueError(f"{path}: expected 1 tensor, found {len(tensors)}")
    return tensors[0]


# ---------------------------------------------------------------------------
# Writer (test fixtures and model export): the archive shape torch::save
# produces, so this reader, the JAX package's and torch::load all read it.
# ---------------------------------------------------------------------------


def _pickle_module(tensors: list[torch.Tensor]) -> bytes:
    # the pickle stream is assembled by hand: the graph is tiny and fixed,
    # and pickle itself refuses to emit the torch globals it names
    out = io.BytesIO()
    w = out.write
    w(b"\x80\x02")  # PROTO 2
    w(b"c__torch__\nModule\n")
    w(b")\x81}(")  # EMPTY_TUPLE NEWOBJ EMPTY_DICT MARK
    for i, t in enumerate(tensors):
        name = str(i).encode()
        w(b"X" + struct.pack("<I", len(name)) + name)
        w(b"ctorch._utils\n_rebuild_tensor_v2\n")
        w(b"((")  # args tuple, persistent-id tuple
        w(b"X\x07\x00\x00\x00storage")
        w(b"ctorch\n" + _DTYPE_TO_STORAGE[t.dtype].encode() + b"\n")
        w(b"X" + struct.pack("<I", len(name)) + name)
        w(b"X\x03\x00\x00\x00cpu")
        w(b"J" + struct.pack("<i", t.numel()))
        w(b"tQ")  # TUPLE BINPERSID
        w(b"K\x00")  # storage_offset 0
        w(b"(")
        for s in t.shape:
            w(b"J" + struct.pack("<i", s))
        w(b"t(")
        for s in t.stride():
            w(b"J" + struct.pack("<i", s))
        w(b"t")
        w(b"\x89")  # requires_grad = False
        w(b"ccollections\nOrderedDict\n)R")
        w(b"t")  # close args tuple
        w(b"R")  # REDUCE -> tensor
    w(b"u")  # SETITEMS
    w(b"b")  # BUILD
    w(b".")  # STOP
    return out.getvalue()


def _storage_bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes()
    return t.numpy().tobytes()


def save_tensor_file(path: Path | str, tensors: list) -> None:
    """Write tensors (``torch.Tensor``s or numpy arrays) as a
    torch-compatible ``.tensor`` archive."""
    path = Path(path)
    root = path.stem or "archive"
    tensors = [
        (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))).detach()
        .cpu().contiguous()
        for t in tensors
    ]
    params = ", ".join(f'"{i}"' for i in range(len(tensors)))
    annotations = "".join(f'\n  __annotations__["{i}"] = Tensor' for i in range(len(tensors)))
    code = (
        "class Module(Module):\n"
        f"  __parameters__ = [{params}, ]\n"
        "  __buffers__ = []\n"
        "  __annotations__ = []" + annotations + "\n"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for i, t in enumerate(tensors):
            z.writestr(f"{root}/data/{i}", _storage_bytes(t))
        z.writestr(f"{root}/data.pkl", _pickle_module(tensors))
        z.writestr(f"{root}/code/__torch__.py", code)
        z.writestr(f"{root}/constants.pkl", b"\x80\x02).")
        z.writestr(f"{root}/version", b"3\n")
