"""A POD5 writer for the port's tests, on pyarrow and zstandard, which the
port's package does not use.

It writes what ``dorado_tpu/io/pod5.py`` and the port's reader parse: the
signature and section markers, the three embedded Arrow IPC files (signal,
run info, reads; the reads table in several record batches with delta
dictionaries), the ``minknow.uuid`` and ``minknow.vbz`` field metadata, and
the footer FlatBuffer. ``fixture_reads`` makes the committed fixture's reads
from its seed; ``python -m tests.torch_pod5_writer`` rewrites that file and
its reads dealt into the four files of ``SHARDS`` (``write_shards``).
"""

from __future__ import annotations

import datetime
import io
import uuid
from pathlib import Path

import flatbuffers
import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import zstandard

from dorado_tpu.io.vbz import svb16_encode

SIGNATURE = b"\x8bPOD\r\n\x1a\n"
FIXTURE = Path(__file__).parent / "data" / "torch_port" / "fixture.pod5"
FIXTURE_SEED = 2024
SHARDS = FIXTURE.parent / "shards"
SIGNAL_ROW = 8000  # samples a signal-table row at most (a read spans several)

_UUID = {"ARROW:extension:name": "minknow.uuid", "ARROW:extension:metadata": ""}
_VBZ = {"ARROW:extension:name": "minknow.vbz", "ARROW:extension:metadata": ""}


def _dict16(values: list[str], words: list[str]) -> pa.DictionaryArray:
    """``values`` dictionary-encoded over ``words``, which grows by the new
    values: a later batch's dictionary extends an earlier one's, which the
    IPC file writer emits as a delta dictionary."""
    words += [v for v in dict.fromkeys(values) if v not in words]
    return pa.DictionaryArray.from_arrays(
        pa.array([words.index(v) for v in values], pa.int16()), pa.array(words, pa.utf8())
    )


def _ipc_file(batches: list[pa.RecordBatch], schema: pa.Schema) -> bytes:
    sink = io.BytesIO()
    with ipc.new_file(sink, schema, options=ipc.IpcWriteOptions(emit_dictionary_deltas=True)) as w:
        for b in batches:
            w.write_batch(b)
    return sink.getvalue()


def _footer(files: list[tuple[int, int, int]]) -> bytes:
    """The footer FlatBuffer: Footer{file_identifier, software, pod5_version,
    contents: [EmbeddedFile{offset, length, format, content_type}]}."""
    b = flatbuffers.Builder(256)
    entries = []
    for offset, length, content in files:
        b.StartObject(4)
        b.PrependInt64Slot(0, offset, 0)
        b.PrependInt64Slot(1, length, 0)
        b.PrependInt8Slot(2, 0, 0)  # format: feather v2 (Arrow IPC)
        b.PrependInt16Slot(3, content, 0)  # content type: 0 reads, 1 signal, 3 run info
        entries.append(b.EndObject())
    b.StartVector(4, len(entries), 4)
    for e in reversed(entries):
        b.PrependUOffsetTRelative(e)
    contents = b.EndVector()
    ident = b.CreateString(str(uuid.UUID(int=7)))
    software = b.CreateString("tests.torch_pod5_writer")
    version = b.CreateString("0.3.10")
    b.StartObject(4)
    b.PrependUOffsetTRelativeSlot(0, ident, 0)
    b.PrependUOffsetTRelativeSlot(1, software, 0)
    b.PrependUOffsetTRelativeSlot(2, version, 0)
    b.PrependUOffsetTRelativeSlot(3, contents, 0)
    b.Finish(b.EndObject())
    return bytes(b.Output())


def write_pod5(path: Path, reads: list[dict], run_infos: list[dict], batch_reads: int = 5,
               corrupt_reads: tuple[int, ...] = ()) -> None:
    """Write ``reads`` (dicts of the reads table's fields plus ``signal``, an
    int16 array, and ``run_info``, an acquisition id) and ``run_infos`` (dicts
    of the run-info table's fields) as a POD5 file. The first signal row of
    each read index in ``corrupt_reads`` gets a truncated VBZ blob."""
    comp = zstandard.ZstdCompressor(level=1)
    sig_ids, sig_blobs, sig_counts, rows_of = [], [], [], []
    for k, r in enumerate(reads):
        rows = []
        signal = np.asarray(r["signal"], np.int16)
        for lo in range(0, max(len(signal), 1), SIGNAL_ROW):
            part = signal[lo : lo + SIGNAL_ROW]
            blob = comp.compress(svb16_encode(part))
            if k in corrupt_reads and lo == 0:
                blob = blob[:-6]  # a truncated zstd frame
            rows.append(len(sig_ids))
            sig_ids.append(r["read_id"].bytes)
            sig_blobs.append(blob)
            sig_counts.append(len(part))
        rows_of.append(rows)
    sig_schema = pa.schema([
        pa.field("read_id", pa.binary(16), metadata=_UUID),
        pa.field("signal", pa.large_binary(), metadata=_VBZ),
        pa.field("samples", pa.uint32()),
    ])
    signal_file = _ipc_file([pa.record_batch([
        pa.array(sig_ids, pa.binary(16)), pa.array(sig_blobs, pa.large_binary()),
        pa.array(sig_counts, pa.uint32()),
    ], schema=sig_schema)], sig_schema)

    ri_types = {
        "acquisition_id": pa.utf8(), "acquisition_start_time": pa.timestamp("ms", tz="UTC"),
        "adc_max": pa.int16(), "adc_min": pa.int16(),
        "context_tags": pa.map_(pa.utf8(), pa.utf8()), "experiment_name": pa.utf8(),
        "flow_cell_id": pa.utf8(), "flow_cell_product_code": pa.utf8(),
        "protocol_name": pa.utf8(), "protocol_run_id": pa.utf8(),
        "protocol_start_time": pa.timestamp("ms", tz="UTC"), "sample_id": pa.utf8(),
        "sample_rate": pa.uint16(), "sequencing_kit": pa.utf8(), "sequencer_position": pa.utf8(),
        "sequencer_position_type": pa.utf8(), "software": pa.utf8(), "system_name": pa.utf8(),
        "system_type": pa.utf8(), "tracking_id": pa.map_(pa.utf8(), pa.utf8()),
    }
    ri_schema = pa.schema([pa.field(k, v) for k, v in ri_types.items()])
    run_info_file = _ipc_file([pa.record_batch(
        [pa.array([ri[k] for ri in run_infos], t) for k, t in ri_types.items()], schema=ri_schema,
    )], ri_schema)

    read_types = {
        "read_id": pa.binary(16), "signal": pa.list_(pa.uint64()), "read_number": pa.uint32(),
        "start": pa.uint64(), "median_before": pa.float32(), "num_minknow_events": pa.uint64(),
        "tracked_scaling_scale": pa.float32(), "tracked_scaling_shift": pa.float32(),
        "predicted_scaling_scale": pa.float32(), "predicted_scaling_shift": pa.float32(),
        "num_reads_since_mux_change": pa.uint32(), "time_since_mux_change": pa.float32(),
        "num_samples": pa.uint64(), "channel": pa.uint16(), "well": pa.uint8(),
        "pore_type": pa.dictionary(pa.int16(), pa.utf8()),
        "calibration_offset": pa.float32(), "calibration_scale": pa.float32(),
        "end_reason": pa.dictionary(pa.int16(), pa.utf8()), "end_reason_forced": pa.bool_(),
        "run_info": pa.dictionary(pa.int16(), pa.utf8()), "open_pore_level": pa.float32(),
    }
    read_schema = pa.schema([
        pa.field(k, v, metadata=_UUID if k == "read_id" else None) for k, v in read_types.items()
    ])
    batches = []
    words: dict[str, list[str]] = {}
    for lo in range(0, len(reads), batch_reads):
        part = range(lo, min(lo + batch_reads, len(reads)))
        cols = []
        for k, t in read_types.items():
            if k == "read_id":
                cols.append(pa.array([reads[i]["read_id"].bytes for i in part], t))
            elif k == "signal":
                cols.append(pa.array([rows_of[i] for i in part], t))
            elif k == "num_samples":
                cols.append(pa.array([len(reads[i]["signal"]) for i in part], t))
            elif pa.types.is_dictionary(t):
                cols.append(_dict16([reads[i][k] for i in part], words.setdefault(k, [])))
            else:
                cols.append(pa.array([reads[i][k] for i in part], t))
        batches.append(pa.record_batch(cols, schema=read_schema))
    reads_file = _ipc_file(batches, read_schema)

    marker = uuid.UUID(int=0x5EC7).bytes
    out = bytearray(SIGNATURE + marker)
    files = []
    for blob, content in ((signal_file, 1), (run_info_file, 3), (reads_file, 0)):
        files.append((len(out), len(blob), content))
        out += blob
        out += b"\x00" * (-len(out) % 8) + marker
    footer = _footer(files)
    out += b"FOOTER\x00\x00" + footer + b"\x00" * (-len(footer) % 8)
    footer_len = len(out) - (len(out) - len(footer) - (-len(footer) % 8))
    out += np.int64(footer_len).tobytes() + marker + SIGNATURE
    Path(path).write_bytes(bytes(out))


def run_info(i: int, rate: int = 5000) -> dict:
    start = datetime.datetime(2024, 3, 1, 12, 0, i, 123000 + 17 * i, tzinfo=datetime.timezone.utc)
    return {
        "acquisition_id": f"acq{i:02d}-{uuid.UUID(int=i + 1).hex[:12]}",
        "acquisition_start_time": start, "adc_max": 4095, "adc_min": -4096,
        "context_tags": [("sample_frequency", str(rate)), ("sequencing_kit", "sqk-lsk114")],
        "experiment_name": f"experiment {i}", "flow_cell_id": f"FAB{i:05d}",
        "flow_cell_product_code": "FLO-PRO114M", "protocol_name": "sequencing/seq.toml",
        "protocol_run_id": f"run-{i}", "protocol_start_time": start, "sample_id": f"sample{i}",
        "sample_rate": rate, "sequencing_kit": "SQK-LSK114", "sequencer_position": f"X{i + 1}",
        "sequencer_position_type": "promethion", "software": "MinKNOW 24.02", "system_name": "host",
        "system_type": "promethion", "tracking_id": [("run_id", f"run-{i}"), ("device_id", "X1")],
    }


def make_reads(seed: int, lengths: list[int], run_infos: list[dict],
               noise: bool = False) -> list[dict]:
    """Reads with piecewise-constant (event-like) signal around the pA
    standardisation mean at 0.2 pA/ADC, or with white noise about it
    (``noise``), and random fields, from ``seed``."""
    rs = np.random.RandomState(seed)
    reads = []
    for i, n in enumerate(lengths):
        if noise:
            signal = np.clip(rs.normal(460, 113, n), -32768, 32767).astype(np.int16)
        else:
            levels = np.repeat(rs.normal(460, 60, n // 8 + 1), 8)[:n]
            signal = np.clip(levels + rs.normal(0, 4, n), -32768, 32767).astype(np.int16)
        reads.append({
            "read_id": uuid.UUID(bytes=rs.bytes(16), version=4), "signal": signal,
            "read_number": int(rs.randint(1, 10**6)), "start": int(rs.randint(0, 10**9)),
            "median_before": float(np.float32(rs.uniform(150, 250))),
            "num_minknow_events": int(rs.randint(0, 10**5)),
            "tracked_scaling_scale": float(np.float32(rs.uniform(1, 2))),
            "tracked_scaling_shift": float(np.float32(rs.uniform(-5, 5))),
            "predicted_scaling_scale": float("nan"), "predicted_scaling_shift": float("nan"),
            "num_reads_since_mux_change": int(rs.randint(0, 50)),
            "time_since_mux_change": float(np.float32(rs.uniform(0, 100))),
            "channel": int(rs.randint(1, 3000)), "well": int(rs.randint(1, 5)),
            "pore_type": ["not_set", "r10.4.1"][i % 2],
            "calibration_offset": float(np.float32(rs.uniform(-10, 10))),
            "calibration_scale": float(np.float32(0.2)),
            "end_reason": ["signal_positive", "unblock_mux_change", "mux_change",
                           "data_service_unblock_mux_change"][rs.randint(4)],
            "end_reason_forced": bool(rs.randint(2)),
            "run_info": run_infos[i % len(run_infos)]["acquisition_id"],
            "open_pore_level": None if i % 3 == 0 else float(np.float32(rs.uniform(200, 260))),
        })
    return reads


def fixture_reads() -> tuple[list[dict], list[dict]]:
    """The committed fixture's reads and run infos: 16 reads of 3k-60k
    samples over two runs."""
    rs = np.random.RandomState(FIXTURE_SEED)
    lengths = [int(n) for n in rs.randint(3_000, 60_001, 16)]
    infos = [run_info(0), run_info(1)]
    return make_reads(FIXTURE_SEED + 1, lengths, infos), infos


def write_shards(directory: Path = SHARDS, count: int = 4) -> list[Path]:
    """The fixture's reads dealt round robin into ``count`` POD5 files
    (``part<i>.pod5``), each with both run infos: the input of a run over
    several processes, which share it by files."""
    reads, infos = fixture_reads()
    directory.mkdir(parents=True, exist_ok=True)
    paths = [directory / f"part{i}.pod5" for i in range(count)]
    for i, path in enumerate(paths):
        write_pod5(path, reads[i::count], infos)
    return paths


if __name__ == "__main__":
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    write_pod5(FIXTURE, *fixture_reads())
    print(FIXTURE, FIXTURE.stat().st_size, "bytes")
    for path in write_shards():
        print(path, path.stat().st_size, "bytes")
