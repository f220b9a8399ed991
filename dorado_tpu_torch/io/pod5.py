"""POD5 reader: raw nanopore signal files, read with numpy alone.

Port of ``dorado_tpu/io/pod5.py`` without pyarrow or zstandard. A POD5
"combined" file embeds three Apache Arrow IPC files (signal table, run-info
table, reads table) between an 8-byte signature and 16-byte section marker
header and a FlatBuffers footer listing the (offset, length) of each
embedded file. The footer is walked by hand, each embedded table read with
``io/arrow_ipc.py``, the tables told apart by their columns, and the VBZ
signal decoded on demand (``io/vbz.py``).

Replaces the reference's pod5 C API usage (dorado/data_loader/DataLoader.cpp).
"""

from __future__ import annotations

import datetime
import functools
import logging
import struct
import sys
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np

from dorado_tpu_torch.io import arrow_ipc
from dorado_tpu_torch.io.vbz import decompress_signal

_logger = logging.getLogger("dorado_tpu_torch.pod5")

_SIGNATURE = b"\x8bPOD\r\n\x1a\n"


@dataclass
class RunInfo:
    acquisition_id: str = ""
    sample_rate: int = 0
    flow_cell_id: str = ""
    flow_cell_product_code: str = ""
    sequencing_kit: str = ""
    experiment_name: str = ""
    sample_id: str = ""
    protocol_run_id: str = ""
    acquisition_start_time_ms: int = 0
    sequencer_position: str = ""
    sequencer_position_type: str = ""
    system_name: str = ""
    software: str = ""
    context_tags: dict = field(default_factory=dict)
    tracking_id: dict = field(default_factory=dict)


@dataclass
class Pod5Read:
    read_id: str
    signal: np.ndarray  # int16
    read_number: int
    start_sample: int
    median_before: float
    channel: int
    well: int
    pore_type: str
    calibration_offset: float
    calibration_scale: float
    end_reason: str
    end_reason_forced: bool
    open_pore_level: float
    num_reads_since_mux_change: int
    time_since_mux_change: float
    num_minknow_events: int
    tracked_scaling_scale: float
    tracked_scaling_shift: float
    predicted_scaling_scale: float
    predicted_scaling_shift: float
    run_info: RunInfo
    filename: str = ""


def _read_footer_embedded_files(data: memoryview) -> list[tuple[int, int]]:
    """Parse the POD5 footer flatbuffer for embedded (offset, length) pairs."""
    size = len(data)
    if size < 40 or bytes(data[:8]) != _SIGNATURE or bytes(data[size - 8 :]) != _SIGNATURE:
        raise ValueError("not a POD5 file (bad signature)")
    footer_len = struct.unpack_from("<q", data, size - 32)[0]
    footer_start = size - 32 - footer_len
    if footer_len <= 0 or footer_start < 8:
        raise ValueError("not a POD5 file (bad footer length)")
    buf = data[footer_start : footer_start + footer_len]

    def u16(pos):
        return struct.unpack_from("<H", buf, pos)[0]

    def i32(pos):
        return struct.unpack_from("<i", buf, pos)[0]

    def u32(pos):
        return struct.unpack_from("<I", buf, pos)[0]

    def i64(pos):
        return struct.unpack_from("<q", buf, pos)[0]

    def table_field(table_pos, field_id):
        """Absolute position of a field's data, or None if absent."""
        vtable_pos = table_pos - i32(table_pos)
        vtable_size = u16(vtable_pos)
        entry = 4 + field_id * 2
        if entry + 2 > vtable_size:
            return None
        off = u16(vtable_pos + entry)
        if off == 0:
            return None
        return table_pos + off

    root = u32(0)
    contents_pos = table_field(root, 3)  # Footer.contents vector
    if contents_pos is None:
        return []
    vec_pos = contents_pos + u32(contents_pos)
    n = u32(vec_pos)
    out = []
    for i in range(n):
        elem_ref = vec_pos + 4 + i * 4
        table_pos = elem_ref + u32(elem_ref)
        off_pos = table_field(table_pos, 0)
        len_pos = table_field(table_pos, 1)
        offset = i64(off_pos) if off_pos is not None else 0
        length = i64(len_pos) if len_pos is not None else 0
        out.append((offset, length))
    return out


def _ms_since_epoch(value, dtype: arrow_ipc.DataType | None) -> int:
    """A timestamp column's value in ms since the epoch, through the same
    ``datetime`` the JAX reader gets from pyarrow (aware when the column has
    a time zone) and its ``int(dt.timestamp() * 1000)``: the two readers then
    agree on every value, rounding included."""
    if value is None:
        return 0
    if dtype is None or dtype.name != "Timestamp":
        return int(value)
    micros = {"s": 10**6, "ms": 10**3, "us": 1}.get(dtype.unit)
    step = datetime.timedelta(microseconds=value * micros if micros else value // 1000)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc if dtype.timezone else None)
    return int((epoch + step).timestamp() * 1000)


class Pod5File:
    """Random-access view of one POD5 file's reads."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        self.reads_skipped = 0  # decode faults skipped by reads()
        data = memoryview(self.path.read_bytes())
        tables: dict[str, arrow_ipc.Table] = {}
        for offset, length in _read_footer_embedded_files(data):
            try:
                table = arrow_ipc.read_file(data[offset : offset + length])
            except arrow_ipc.ArrowInvalid:
                continue  # not an Arrow file (as pyarrow's ArrowInvalid is skipped there)
            names = set(table.column_names)
            if {"signal", "samples"} <= names:
                tables["signal"] = table
            elif "acquisition_id" in names:
                tables["run_info"] = table
            elif "read_id" in names:
                tables["reads"] = table
        if "reads" not in tables or "signal" not in tables:
            raise ValueError(f"{path}: missing reads/signal tables")
        self._reads = tables["reads"]
        self._signal = tables["signal"]
        self._run_infos = self._parse_run_infos(tables.get("run_info"))

    @functools.cached_property
    def _rows(self) -> dict[str, list]:
        """The reads table's columns as Python lists, decoded at first use
        (``build_header`` needs only the run infos)."""
        return {name: self._reads.column(name).to_pylist() for name in self._reads.column_names}

    @functools.cached_property
    def _sig_samples(self) -> np.ndarray:
        return self._signal.column("samples").to_numpy().astype(np.int64)

    @functools.cached_property
    def _sig_blobs(self) -> list[bytes]:
        return self._signal.column("signal").to_pylist()

    @staticmethod
    def _parse_run_infos(table: arrow_ipc.Table | None) -> list[RunInfo]:
        if table is None:
            return [RunInfo()]
        cols = {name: table.column(name).to_pylist() for name in table.column_names}
        start_type = (
            table.column("acquisition_start_time").field.type
            if "acquisition_start_time" in table else None
        )
        infos = []
        for i in range(table.num_rows):
            row = {name: col[i] for name, col in cols.items()}
            infos.append(
                RunInfo(
                    acquisition_id=row.get("acquisition_id", ""),
                    sample_rate=int(row.get("sample_rate") or 0),
                    flow_cell_id=row.get("flow_cell_id", "") or "",
                    flow_cell_product_code=row.get("flow_cell_product_code", "") or "",
                    sequencing_kit=row.get("sequencing_kit", "") or "",
                    experiment_name=row.get("experiment_name", "") or "",
                    sample_id=row.get("sample_id", "") or "",
                    protocol_run_id=row.get("protocol_run_id", "") or "",
                    acquisition_start_time_ms=_ms_since_epoch(
                        row.get("acquisition_start_time"), start_type
                    ),
                    sequencer_position=row.get("sequencer_position", "") or "",
                    sequencer_position_type=row.get("sequencer_position_type", "") or "",
                    system_name=row.get("system_name", "") or "",
                    software=row.get("software", "") or "",
                    context_tags=dict(row.get("context_tags") or {}),
                    tracking_id=dict(row.get("tracking_id") or {}),
                )
            )
        return infos

    @property
    def num_reads(self) -> int:
        return self._reads.num_rows

    @property
    def run_infos(self) -> list[RunInfo]:
        return list(self._run_infos)

    def read_ids(self) -> list[str]:
        return [str(uuid.UUID(bytes=b)) for b in self._rows["read_id"]]

    def _signal_for_rows(self, rows: list[int], total: int) -> np.ndarray:
        out = np.empty(total, dtype=np.int16)
        pos = 0
        for row in rows:
            count = int(self._sig_samples[row])
            out[pos : pos + count] = decompress_signal(self._sig_blobs[row], count)
            pos += count
        return out[:pos]

    def get_read(self, index: int) -> Pod5Read:
        row = {name: col[index] for name, col in self._rows.items()}
        signal_rows = [int(r) for r in row["signal"]]
        total = int(sum(self._sig_samples[r] for r in signal_rows))
        expected = int(row.get("num_samples") or total)
        signal = self._signal_for_rows(signal_rows, total)

        run_info_idx = row.get("run_info", 0)
        if isinstance(run_info_idx, str):
            # the run_info column holds the acquisition id: match it
            matches = [
                i for i, ri in enumerate(self._run_infos) if ri.acquisition_id == run_info_idx
            ]
            run_info_idx = matches[0] if matches else 0
        run_info = self._run_infos[int(run_info_idx or 0)]

        def _enum(v):
            return str(v) if v is not None else ""

        return Pod5Read(
            read_id=str(uuid.UUID(bytes=row["read_id"])),
            signal=signal[:expected] if expected <= len(signal) else signal,
            read_number=int(row.get("read_number") or 0),
            start_sample=int(row.get("start") or 0),
            median_before=float(row.get("median_before") or 0.0),
            channel=int(row.get("channel") or 0),
            well=int(row.get("well") or 0),
            pore_type=_enum(row.get("pore_type")),
            calibration_offset=float(row.get("calibration_offset") or 0.0),
            calibration_scale=float(row.get("calibration_scale") or 0.0),
            end_reason=_enum(row.get("end_reason")),
            end_reason_forced=bool(row.get("end_reason_forced")),
            open_pore_level=float(
                row["open_pore_level"] if row.get("open_pore_level") is not None else float("nan")
            ),
            num_reads_since_mux_change=int(row.get("num_reads_since_mux_change") or 0),
            time_since_mux_change=float(row.get("time_since_mux_change") or 0.0),
            num_minknow_events=int(row.get("num_minknow_events") or 0),
            tracked_scaling_scale=float(row.get("tracked_scaling_scale") or 0.0),
            tracked_scaling_shift=float(row.get("tracked_scaling_shift") or 0.0),
            predicted_scaling_scale=float(row.get("predicted_scaling_scale") or 0.0),
            predicted_scaling_shift=float(row.get("predicted_scaling_shift") or 0.0),
            run_info=run_info,
        )

    def reads(self, strict: bool = False) -> Iterator[Pod5Read]:
        """Iterate reads; by default a read whose row or signal fails to
        decode is logged and skipped, so one corrupt record cannot abort a
        whole run (DataLoader.cpp:76-93 logs and skips per row). Skips are
        counted in ``self.reads_skipped``; strict=True re-raises instead."""
        for i in range(self.num_reads):
            try:
                yield self.get_read(i)
            except Exception as exc:  # noqa: BLE001 -- any decode fault of one row
                if strict:
                    raise
                self.reads_skipped += 1
                _logger.error(
                    "POD5 failed to decode read - '%s' @ '%s' (row %d); skipped.",
                    exc, self.path, i,
                )

    def channel_order(self) -> list[tuple[int, int]]:
        """(channel, start sample) of each row, for channel-sorted reading."""
        return [(int(c or 0), int(s or 0))
                for c, s in zip(self._rows["channel"], self._rows["start"])]


def find_pod5_files(path: Path | str, recursive: bool = False) -> list[Path]:
    """Directory scan for .pod5 inputs (DataLoader.cpp:36-67 semantics,
    including the FAST5 rejection with a conversion pointer)."""
    path = Path(path)
    if path.is_file():
        return [path]
    pattern = "**/*" if recursive else "*"
    pod5s, fast5_found = [], False
    for p in path.glob(pattern):
        if p.suffix == ".pod5":
            pod5s.append(p)
        elif p.suffix == ".fast5":
            fast5_found = True
    if fast5_found and not pod5s:
        raise RuntimeError(
            "FAST5 files are not supported. Please convert your dataset to "
            "POD5: https://pod5-file-format.readthedocs.io/en/latest/docs/"
            "tools.html#pod5-convert-fast5"
        )
    if fast5_found:
        print("> WARNING: FAST5 files found; they will be ignored (POD5 only).", file=sys.stderr)
    return sorted(pod5s)


def iter_reads(paths: list[Path], by_channel: bool = False) -> Iterator[Pod5Read]:
    """Stream reads from many POD5 files; ``by_channel`` yields them sorted by
    (channel, start sample) across the files (ReadOrder::BY_CHANNEL)."""
    if not by_channel:
        for p in paths:
            yield from Pod5File(p).reads()
        return
    files = [Pod5File(p) for p in paths]
    entries = [
        (channel, start, f, i)
        for f in files
        for i, (channel, start) in enumerate(f.channel_order())
    ]
    entries.sort(key=lambda e: (e[0], e[1]))
    for _, _, f, i in entries:
        yield f.get_read(i)
