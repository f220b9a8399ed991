"""Reader of the Apache Arrow IPC *file* format, for the tables of a POD5 file.

The JAX package reads POD5's embedded Arrow files with ``pyarrow.ipc``; the
port reads them with this module and numpy alone. It walks the FlatBuffers
metadata itself (Schema.fbs, Message.fbs, File.fbs of the Arrow format):

  - the ``ARROW1`` magic, the footer (schema, dictionary blocks, record-batch
    blocks) and each block's encapsulated ``Message``;
  - ``RecordBatch`` and ``DictionaryBatch`` messages, a delta dictionary
    (``isDelta``) appending to the dictionary of its id;
  - each array's buffers at their stated offsets in the message body, and
    validity bitmaps;
  - the types a POD5 file holds: signed and unsigned integers of 8 to 64
    bits, float16/32/64, bool, utf8, binary and their large (64-bit offset)
    forms, fixed_size_binary (storage of the ``minknow.uuid`` extension),
    list, map, struct, timestamp, and dictionary-encoded columns;
  - a table of several record batches.

A compressed message body, a big-endian file or any other type raises
``ArrowUnsupported`` naming what it met; a file that is not Arrow IPC raises
``ArrowInvalid``. Nothing is read past a buffer's end or guessed.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

MAGIC = b"ARROW1"

# the Type union's members (Schema.fbs), by their union tag
_TYPE_NAMES = {
    0: "NONE", 1: "Null", 2: "Int", 3: "FloatingPoint", 4: "Binary", 5: "Utf8", 6: "Bool",
    7: "Decimal", 8: "Date", 9: "Time", 10: "Timestamp", 11: "Interval", 12: "List",
    13: "Struct_", 14: "Union", 15: "FixedSizeBinary", 16: "FixedSizeList", 17: "Map",
    18: "Duration", 19: "LargeBinary", 20: "LargeUtf8", 21: "LargeList", 22: "RunEndEncoded",
    23: "BinaryView", 24: "Utf8View", 25: "ListView", 26: "LargeListView",
}
_SUPPORTED = {2, 3, 4, 5, 6, 10, 12, 13, 15, 17, 19, 20}
_MESSAGE_DICTIONARY, _MESSAGE_RECORD_BATCH = 2, 3  # MessageHeader union tags
_TIME_UNITS = ("s", "ms", "us", "ns")
_FLOAT_DTYPES = (np.float16, np.float32, np.float64)  # Precision HALF, SINGLE, DOUBLE


class ArrowInvalid(ValueError):
    """The bytes are not an Arrow IPC file, or its metadata is malformed."""


class ArrowUnsupported(ValueError):
    """A well-formed file that uses a feature this reader does not decode."""


# ---------------------------------------------------------------------------
# FlatBuffers
# ---------------------------------------------------------------------------


class _Table:
    """A FlatBuffers table at ``pos`` of ``buf``."""

    __slots__ = ("buf", "pos", "_vt", "_vt_len")

    def __init__(self, buf: memoryview, pos: int):
        self.buf = buf
        self.pos = pos
        try:
            self._vt = pos - struct.unpack_from("<i", buf, pos)[0]
            self._vt_len = struct.unpack_from("<H", buf, self._vt)[0]
        except struct.error as exc:
            raise ArrowInvalid(f"flatbuffer table out of bounds at {pos}") from exc

    def _field(self, i: int) -> int | None:
        entry = 4 + 2 * i
        if entry + 2 > self._vt_len:
            return None
        off = struct.unpack_from("<H", self.buf, self._vt + entry)[0]
        return self.pos + off if off else None

    def scalar(self, i: int, fmt: str, default=0):
        p = self._field(i)
        return default if p is None else struct.unpack_from("<" + fmt, self.buf, p)[0]

    def _ref(self, i: int) -> int | None:
        p = self._field(i)
        return None if p is None else p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, i: int) -> "_Table | None":
        p = self._ref(i)
        return None if p is None else _Table(self.buf, p)

    def string(self, i: int) -> str | None:
        p = self._ref(i)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        return bytes(self.buf[p + 4 : p + 4 + n]).decode()

    def vector(self, i: int) -> tuple[int, int]:
        """(position of the first element, element count); (0, 0) if absent."""
        p = self._ref(i)
        if p is None:
            return 0, 0
        return p + 4, struct.unpack_from("<I", self.buf, p)[0]

    def tables(self, i: int) -> list["_Table"]:
        start, n = self.vector(i)
        out = []
        for k in range(n):
            e = start + 4 * k
            out.append(_Table(self.buf, e + struct.unpack_from("<I", self.buf, e)[0]))
        return out


def _root(buf: memoryview) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


@dataclass
class DataType:
    """An Arrow type: ``name`` is the Type union member's name (``Int``,
    ``Utf8``, ...); the other fields hold its parameters."""

    name: str
    bit_width: int = 0
    signed: bool = False
    byte_width: int = 0
    float_dtype: type | None = None
    unit: str = ""
    timezone: str | None = None

    def numpy_dtype(self) -> np.dtype:
        if self.name == "Int":
            return np.dtype(f"<{'i' if self.signed else 'u'}{self.bit_width // 8}")
        if self.name == "FloatingPoint":
            return np.dtype(self.float_dtype).newbyteorder("<")
        if self.name == "Timestamp":
            return np.dtype("<i8")
        raise ArrowUnsupported(f"no numpy dtype for Arrow type {self.name}")


@dataclass
class Field:
    name: str
    type: DataType
    nullable: bool
    children: list["Field"] = field(default_factory=list)
    metadata: dict[str, str] = field(default_factory=dict)
    dictionary_id: int | None = None  # set for a dictionary-encoded field
    index_type: DataType | None = None  # the dictionary's index type


def _key_values(t: _Table, i: int) -> dict[str, str]:
    return {kv.string(0): kv.string(1) for kv in t.tables(i)}


def _parse_type(type_id: int, t: _Table | None) -> DataType:
    name = _TYPE_NAMES.get(type_id, f"type {type_id}")
    if type_id not in _SUPPORTED:
        raise ArrowUnsupported(f"Arrow type {name} is not supported by this reader")
    if type_id == 2:
        bits = t.scalar(0, "i")
        if bits not in (8, 16, 32, 64):
            raise ArrowInvalid(f"Int of {bits} bits")
        return DataType(name, bit_width=bits, signed=bool(t.scalar(1, "B")))
    if type_id == 3:
        precision = t.scalar(0, "h")
        if precision not in (0, 1, 2):
            raise ArrowInvalid(f"FloatingPoint precision {precision}")
        return DataType(name, float_dtype=_FLOAT_DTYPES[precision])
    if type_id == 10:
        return DataType(name, unit=_TIME_UNITS[t.scalar(0, "h")], timezone=t.string(1))
    if type_id == 15:
        return DataType(name, byte_width=t.scalar(0, "i"))
    return DataType(name)  # Map's keysSorted does not change its layout


def _parse_field(t: _Table) -> Field:
    dtype = _parse_type(t.scalar(2, "B"), t.table(3))
    f = Field(
        name=t.string(0) or "",
        type=dtype,
        nullable=bool(t.scalar(1, "B")),
        children=[_parse_field(c) for c in t.tables(5)],
        metadata=_key_values(t, 6),
    )
    dictionary = t.table(4)
    if dictionary is not None:
        f.dictionary_id = dictionary.scalar(0, "q")
        index = dictionary.table(1)
        f.index_type = (
            DataType("Int", bit_width=32, signed=True) if index is None
            else _parse_type(2, index)
        )
    return f


def _parse_schema(t: _Table) -> list[Field]:
    if t.scalar(0, "h") != 0:
        raise ArrowUnsupported("big-endian Arrow data is not supported by this reader")
    return [_parse_field(f) for f in t.tables(1)]


# ---------------------------------------------------------------------------
# Arrays
# ---------------------------------------------------------------------------


@dataclass
class _Array:
    """One array of a record batch: its type's field, length and buffers."""

    field: Field
    length: int
    valid: np.ndarray | None  # bool per element, None when no element is null
    buffers: list[memoryview]
    children: list["_Array"]


def _bits(buf: memoryview, length: int) -> np.ndarray:
    if len(buf) * 8 < length:
        raise ArrowInvalid("bitmap shorter than its array")
    return np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")[:length].astype(bool)


class _BatchReader:
    """Walks a record batch's field nodes and buffers, depth first."""

    def __init__(self, batch: _Table, body: memoryview):
        if batch.table(3) is not None:
            raise ArrowUnsupported("compressed Arrow IPC bodies are not supported by this reader")
        self.length = batch.scalar(0, "q")
        start, n = batch.vector(1)
        self.nodes = [struct.unpack_from("<qq", batch.buf, start + 16 * k) for k in range(n)]
        start, n = batch.vector(2)
        self.buffers = [struct.unpack_from("<qq", batch.buf, start + 16 * k) for k in range(n)]
        self.body = body
        self._node = self._buffer = 0

    def _next_buffer(self) -> memoryview:
        if self._buffer >= len(self.buffers):
            raise ArrowInvalid("record batch has fewer buffers than its schema needs")
        offset, length = self.buffers[self._buffer]
        self._buffer += 1
        if offset < 0 or length < 0 or offset + length > len(self.body):
            raise ArrowInvalid("buffer outside the message body")
        return self.body[offset : offset + length]

    def read(self, f: Field, as_index: bool = False) -> _Array:
        if self._node >= len(self.nodes):
            raise ArrowInvalid("record batch has fewer field nodes than its schema")
        length, null_count = self.nodes[self._node]
        self._node += 1
        dtype = f.index_type if as_index else f.type
        name = dtype.name
        validity = self._next_buffer()
        valid = _bits(validity, length) if null_count and len(validity) else None
        if name in ("Int", "FloatingPoint", "Bool", "Timestamp", "FixedSizeBinary"):
            buffers = [self._next_buffer()]
        elif name in ("Binary", "Utf8", "LargeBinary", "LargeUtf8"):
            buffers = [self._next_buffer(), self._next_buffer()]
        elif name in ("List", "Map"):
            buffers = [self._next_buffer()]
        else:  # Struct_
            buffers = []
        children = [] if as_index else [self.read(c) for c in f.children]
        return _Array(f, length, valid, buffers, children)


def _offsets(buf: memoryview, length: int, large: bool) -> np.ndarray:
    dtype = np.dtype("<i8" if large else "<i4")
    if len(buf) < (length + 1) * dtype.itemsize:
        raise ArrowInvalid("offsets buffer shorter than its array")
    return np.frombuffer(buf, dtype, count=length + 1).astype(np.int64)


def _values(arr: _Array, dtype: DataType, dictionaries: dict[int, list]) -> list:
    """The array's elements as Python values (None where null)."""
    n = arr.length
    name = dtype.name
    if name in ("Int", "FloatingPoint", "Timestamp"):
        out = _numpy(arr, dtype).tolist()
    elif name == "Bool":
        out = _bits(arr.buffers[0], n).tolist()
    elif name in ("Binary", "Utf8", "LargeBinary", "LargeUtf8"):
        offs = _offsets(arr.buffers[0], n, name.startswith("Large"))
        data = arr.buffers[1]
        if n and (offs[0] < 0 or offs[-1] > len(data) or np.any(np.diff(offs) < 0)):
            raise ArrowInvalid(f"{name} offsets outside the data buffer")
        raw = [bytes(data[offs[i] : offs[i + 1]]) for i in range(n)]
        out = [r.decode() for r in raw] if name.endswith("Utf8") else raw
    elif name == "FixedSizeBinary":
        w = dtype.byte_width
        data = arr.buffers[0]
        if len(data) < n * w:
            raise ArrowInvalid("FixedSizeBinary data shorter than its array")
        out = [bytes(data[i * w : (i + 1) * w]) for i in range(n)]
    elif name in ("List", "Map"):
        offs = _offsets(arr.buffers[0], n, False)
        child = arr.children[0]
        items = _values(child, child.field.type, dictionaries)
        if name == "Map":
            items = [None if e is None else (e[0], e[1]) for e in items]
        if n and (offs[0] < 0 or offs[-1] > len(items) or np.any(np.diff(offs) < 0)):
            raise ArrowInvalid(f"{name} offsets outside the child array")
        out = [items[offs[i] : offs[i + 1]] for i in range(n)]
    elif name == "Struct_":
        cols = [_values(c, c.field.type, dictionaries) for c in arr.children]
        out = [tuple(col[i] for col in cols) for i in range(n)]
    else:
        raise ArrowUnsupported(f"Arrow type {name} is not supported by this reader")
    if arr.valid is not None:
        out = [v if ok else None for v, ok in zip(out, arr.valid.tolist())]
    return out


def _numpy(arr: _Array, dtype: DataType) -> np.ndarray:
    npd = dtype.numpy_dtype()
    if len(arr.buffers[0]) < arr.length * npd.itemsize:
        raise ArrowInvalid(f"{dtype.name} data shorter than its array")
    return np.frombuffer(arr.buffers[0], npd, count=arr.length)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


class Column:
    """One column of a table: its field and one array per record batch."""

    def __init__(self, f: Field, chunks: list[_Array], dictionaries: dict[int, list]):
        self.field = f
        self._chunks = chunks
        self._dictionaries = dictionaries

    def __len__(self) -> int:
        return sum(c.length for c in self._chunks)

    @property
    def null_count(self) -> int:
        return sum(0 if c.valid is None else int((~c.valid).sum()) for c in self._chunks)

    def to_pylist(self) -> list:
        """Python values, None where null: ints, floats, bools, str, bytes,
        lists, maps as lists of (key, value) tuples, timestamps as ints in
        the type's unit; a dictionary-encoded column's values looked up."""
        out: list = []
        f = self.field
        for chunk in self._chunks:
            if f.dictionary_id is None:
                out += _values(chunk, f.type, self._dictionaries)
                continue
            dictionary = self._dictionaries.get(f.dictionary_id)
            if dictionary is None:
                raise ArrowInvalid(f"column {f.name!r}: no dictionary with id {f.dictionary_id}")
            for i in _values(chunk, f.index_type, self._dictionaries):
                if i is not None and not 0 <= i < len(dictionary):
                    raise ArrowInvalid(f"column {f.name!r}: dictionary index {i} out of range")
                out.append(None if i is None else dictionary[i])
        return out

    def to_numpy(self) -> np.ndarray:
        """The values of an integer, float, bool or timestamp column without
        nulls as one numpy array."""
        f = self.field
        if f.dictionary_id is not None or self.null_count:
            raise ArrowUnsupported(f"column {f.name!r}: no numpy view of a dictionary or "
                                   f"nullable column")
        if f.type.name == "Bool":
            parts = [_bits(c.buffers[0], c.length) for c in self._chunks]
            return np.concatenate(parts) if parts else np.zeros(0, bool)
        npd = f.type.numpy_dtype()
        parts = [_numpy(c, f.type) for c in self._chunks]
        return np.concatenate(parts) if parts else np.zeros(0, npd)


class Table:
    """The schema and record batches of one Arrow IPC file."""

    def __init__(self, schema: list[Field], metadata: dict[str, str], batches: list[list[_Array]],
                 dictionaries: dict[int, list]):
        self.schema = schema
        self.metadata = metadata
        self.num_rows = sum(b[0].length for b in batches if b) if schema else 0
        self._columns = {
            f.name: Column(f, [b[i] for b in batches], dictionaries) for i, f in enumerate(schema)
        }

    @property
    def column_names(self) -> list[str]:
        return [f.name for f in self.schema]

    def column(self, name: str) -> Column:
        return self._columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._columns


def _message(data: memoryview, offset: int, meta_len: int, body_len: int) -> tuple[_Table, memoryview]:
    """The Message table of a footer block and its body."""
    end = offset + meta_len + body_len
    if offset < 0 or meta_len < 8 or body_len < 0 or end > len(data):
        raise ArrowInvalid("block outside the file")
    (marker,) = struct.unpack_from("<I", data, offset)
    fb = offset + 8 if marker == 0xFFFFFFFF else offset + 4  # pre-1.0 messages lack the marker
    size = struct.unpack_from("<i", data, fb - 4)[0]
    if size <= 0 or fb + size > offset + meta_len:
        raise ArrowInvalid("message metadata outside its block")
    msg = _root(data[fb : fb + size])
    return msg, data[offset + meta_len : end]


def read_file(data: bytes | memoryview) -> Table:
    """Parse a whole Arrow IPC file held in memory."""
    data = memoryview(data)
    size = len(data)
    if size < 18 or bytes(data[:6]) != MAGIC or bytes(data[size - 6 :]) != MAGIC:
        raise ArrowInvalid("not an Arrow IPC file (no ARROW1 magic)")
    footer_len = struct.unpack_from("<i", data, size - 10)[0]
    start = size - 10 - footer_len
    if footer_len <= 0 or start < 8:
        raise ArrowInvalid("bad Arrow footer length")
    footer = _root(data[start : size - 10])
    schema_t = footer.table(1)
    if schema_t is None:
        raise ArrowInvalid("Arrow footer without a schema")
    schema = _parse_schema(schema_t)
    metadata = _key_values(schema_t, 2)

    def blocks(i):
        s, n = footer.vector(i)
        return [struct.unpack_from("<qi4xq", footer.buf, s + 24 * k) for k in range(n)]

    by_id = {}
    stack = list(schema)
    while stack:
        f = stack.pop()
        if f.dictionary_id is not None:
            by_id[f.dictionary_id] = f
        stack += f.children
    dictionaries: dict[int, list] = {}
    for offset, meta_len, body_len in blocks(2):
        msg, body = _message(data, offset, meta_len, body_len)
        if msg.scalar(1, "B") != _MESSAGE_DICTIONARY:
            raise ArrowInvalid("a dictionary block holds no DictionaryBatch")
        header = msg.table(2)
        dict_id = header.scalar(0, "q")
        f = by_id.get(dict_id)
        if f is None:
            raise ArrowInvalid(f"dictionary batch for unknown id {dict_id}")
        value_field = Field(f.name, f.type, True, f.children)
        reader = _BatchReader(header.table(1), body)
        values = _values(reader.read(value_field), f.type, dictionaries)
        if header.scalar(2, "B"):  # isDelta
            dictionaries.setdefault(dict_id, []).extend(values)
        else:
            dictionaries[dict_id] = values
    batches = []
    for offset, meta_len, body_len in blocks(3):
        msg, body = _message(data, offset, meta_len, body_len)
        if msg.scalar(1, "B") != _MESSAGE_RECORD_BATCH:
            raise ArrowInvalid("a record-batch block holds no RecordBatch")
        reader = _BatchReader(msg.table(2), body)
        arrays = [reader.read(f, as_index=f.dictionary_id is not None) for f in schema]
        if any(a.length != reader.length for a in arrays):
            raise ArrowInvalid("a column's length differs from its record batch's")
        batches.append(arrays)
    return Table(schema, metadata, batches, dictionaries)
