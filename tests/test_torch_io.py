"""The port's file readers without pyarrow, zstandard or ml_dtypes, against
the JAX package's and pyarrow on the same bytes: ``.tensor`` weight files,
the VBZ signal codec (libzstd through ctypes), the Arrow IPC reader, and
BAM and SAM read back (``io/bam_reader.py``)."""

import datetime
import io

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest
import torch
import zstandard

from dorado_tpu.io import tensor_file as jax_tensor_file
from dorado_tpu.io import vbz as jax_vbz
from dorado_tpu.io.bam_reader import read_records as jax_read_records
from dorado_tpu_torch.io import arrow_ipc, bgzf, tensor_file, vbz
from dorado_tpu_torch.io.bam_reader import read_records
from dorado_tpu_torch.io.sam import BamWriter, SamHeader, SamRecord, SamTag, SamWriter

# ---------------------------------------------------------------------------
# .tensor files
# ---------------------------------------------------------------------------


def test_tensor_file_reads_jax_written_archives(tmp_path):
    rs = np.random.RandomState(0)
    tensors = [
        rs.randn(3, 4, 5).astype(np.float32),
        rs.randn(7).astype(np.float64),
        rs.randint(-128, 127, (2, 3)).astype(np.int8),
        rs.randn(6, 2).astype(ml_dtypes.bfloat16),
        np.float32(2.5),
    ]
    jax_tensor_file.save_tensor_file(tmp_path / "w.tensor", tensors)
    out = tensor_file.load_tensor_file(tmp_path / "w.tensor")
    assert [t.dtype for t in out] == [
        torch.float32, torch.float64, torch.int8, torch.bfloat16, torch.float32]
    for a, b in zip(tensors, out):
        assert tuple(b.shape) == np.shape(a)
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))


def test_tensor_file_bf16_round_trip_both_readers(tmp_path):
    """A bf16 tensor the port writes comes back bit for bit through the
    port's reader and the JAX package's."""
    t = torch.from_numpy(np.random.RandomState(1).randn(5, 9).astype(np.float32)).bfloat16()
    tensor_file.save_tensor_file(tmp_path / "b.tensor", [t, torch.arange(4, dtype=torch.int16)])
    back = tensor_file.load_tensor_file(tmp_path / "b.tensor")
    assert back[0].dtype == torch.bfloat16 and torch.equal(back[0], t)
    assert torch.equal(back[1], torch.arange(4, dtype=torch.int16))
    theirs = jax_tensor_file.load_tensor_file(tmp_path / "b.tensor")
    assert theirs[0].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(theirs[0].view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
    with pytest.raises(ValueError, match="expected 1 tensor"):
        tensor_file.load_tensor(tmp_path / "b.tensor")


def test_tensor_file_refuses_other_globals(tmp_path):
    """The restricted unpickler names what it will not build."""
    import zipfile

    with zipfile.ZipFile(tmp_path / "x.tensor", "w") as z:
        z.writestr("x/data.pkl", b"\x80\x02cos\nsystem\n.")
    with pytest.raises(Exception, match="unsupported global os.system"):
        tensor_file.load_tensor_file(tmp_path / "x.tensor")


# ---------------------------------------------------------------------------
# VBZ
# ---------------------------------------------------------------------------


def _signal(n: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    # small steps and a few large ones: both svb16 widths
    steps = np.where(rs.rand(n) < 0.05, rs.randint(-3000, 3000, n), rs.randint(-30, 30, n))
    return (np.cumsum(steps) % 20000 - 10000).astype(np.int16)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 50_000])
def test_vbz_matches_jax(n):
    sig = _signal(n, n)
    ours, theirs = vbz.compress_signal(sig), jax_vbz.compress_signal(sig)
    assert vbz.svb16_encode(sig) == jax_vbz.svb16_encode(sig)
    # the same zstd level: the same frame
    assert ours == theirs
    for blob in (ours, theirs):
        out = vbz.decompress_signal(blob, n)
        assert out.dtype == np.int16
        np.testing.assert_array_equal(out, sig)
        np.testing.assert_array_equal(jax_vbz.decompress_signal(blob, n), sig)
    # an uncompressed row (2 bytes a sample) is taken as it is
    np.testing.assert_array_equal(vbz.decompress_signal(sig.tobytes(), n), sig)


def test_vbz_corrupt_payloads_raise():
    sig = _signal(1000, 3)
    payload = vbz.svb16_encode(sig)
    comp = zstandard.ZstdCompressor(level=1)
    cases = {
        "payload size mismatch": comp.compress(payload[:-3]),
        "shorter than svb16 key stream": comp.compress(payload[:50]),
        "not a zstd frame": b"\x00" * 40,
    }
    for match, blob in cases.items():
        with pytest.raises(ValueError, match=match):
            vbz.decompress_signal(blob, len(sig))
    # a frame that says it holds more than the samples can take
    with pytest.raises(ValueError, match="corrupt VBZ"):
        vbz.decompress_signal(comp.compress(payload + b"\x00" * 500), len(sig))
    # a damaged frame body: zstd's own error
    blob = bytearray(comp.compress(payload))
    blob[len(blob) // 2 :] = b"\xff" * (len(blob) - len(blob) // 2)
    with pytest.raises(ValueError, match="corrupt VBZ"):
        vbz.decompress_signal(bytes(blob), len(sig))
    assert vbz.libzstd_version().startswith("libzstd")


# ---------------------------------------------------------------------------
# Arrow IPC
# ---------------------------------------------------------------------------


def _batch(n: int, seed: int, words: list[str]) -> pa.RecordBatch:
    """Every type a POD5 file holds, with nulls; the dictionary column over
    ``words``, which a later batch extends (a delta dictionary)."""
    rs = np.random.RandomState(seed)
    cols = {}
    for bits in (8, 16, 32, 64):
        for signed in (True, False):
            t = getattr(pa, f"{'int' if signed else 'uint'}{bits}")()
            info = np.iinfo(t.to_pandas_dtype())
            vals = rs.randint(max(info.min, -2**62), min(info.max, 2**62), n, dtype=np.int64)
            cols[str(t)] = pa.array([None if i % 6 == 0 else int(v) for i, v in enumerate(vals)], t)
    cols["f16"] = pa.array(rs.randn(n).astype(np.float16), pa.float16())
    cols["f32"] = pa.array([None if i % 3 == 0 else float(np.float32(v))
                            for i, v in enumerate(rs.randn(n))], pa.float32())
    cols["f64"] = pa.array(rs.randn(n), pa.float64())
    cols["bool"] = pa.array([None if i % 5 == 0 else bool(i % 2) for i in range(n)], pa.bool_())
    cols["utf8"] = pa.array([None if i % 4 == 1 else "x" * i + "é" for i in range(n)])
    cols["binary"] = pa.array([rs.bytes(i % 7) for i in range(n)], pa.binary())
    cols["large_binary"] = pa.array([rs.bytes(i % 9) for i in range(n)], pa.large_binary())
    cols["large_utf8"] = pa.array([str(i) for i in range(n)], pa.large_utf8())
    cols["uuid"] = pa.array([rs.bytes(16) for _ in range(n)], pa.binary(16))
    cols["list"] = pa.array([None if i == 2 else list(range(i % 4)) for i in range(n)],
                            pa.list_(pa.uint64()))
    cols["map"] = pa.array(
        [None if i == 1 else [(f"k{j}", f"v{i * j}") for j in range(i % 3)] for i in range(n)],
        pa.map_(pa.utf8(), pa.utf8()))
    epoch = datetime.datetime(2023, 1, 1, tzinfo=datetime.timezone.utc)
    cols["timestamp"] = pa.array(
        [epoch + datetime.timedelta(milliseconds=int(v)) for v in rs.randint(0, 10**9, n)],
        pa.timestamp("ms", tz="UTC"))
    cols["timestamp_us"] = pa.array(rs.randint(0, 10**12, n), pa.timestamp("us"))
    words += [w for w in ("alpha", "beta", "gamma", "delta")[: 2 + seed] if w not in words]
    cols["dictionary"] = pa.DictionaryArray.from_arrays(
        pa.array([None if i == 3 else i % len(words) for i in range(n)], pa.int16()),
        pa.array(words))
    return pa.record_batch(list(cols.values()), names=list(cols))


def _ipc(batches, **options) -> bytes:
    sink = io.BytesIO()
    opts = ipc.IpcWriteOptions(emit_dictionary_deltas=True, **options)
    schema = batches[0].schema.with_metadata({"MINKNOW:pod5_version": "0.3.10"})
    with ipc.new_file(sink, schema, options=opts) as w:
        for b in batches:
            w.write_batch(b.replace_schema_metadata(schema.metadata))
    return sink.getvalue()


def test_arrow_reader_matches_pyarrow():
    words: list[str] = []
    data = _ipc([_batch(11, 0, words), _batch(7, 1, words), _batch(5, 2, words)])
    ref = ipc.open_file(pa.py_buffer(data))
    assert ref.num_record_batches == 3
    ref = ref.read_all()
    table = arrow_ipc.read_file(data)
    assert table.num_rows == ref.num_rows == 23
    assert table.column_names == ref.column_names
    assert table.metadata == {"MINKNOW:pod5_version": "0.3.10"}
    for name in ref.column_names:
        col = ref.column(name)
        want = (col.cast(pa.int64()) if pa.types.is_timestamp(col.type) else col).to_pylist()
        got = table.column(name).to_pylist()
        if pa.types.is_floating(col.type):
            got = [None if v is None else float(v) for v in got]
        assert got == want, name
        assert table.column(name).null_count == col.null_count, name
    assert table.column("timestamp").field.type.unit == "ms"
    assert table.column("timestamp").field.type.timezone == "UTC"
    # the later batches' words came in delta dictionaries
    assert set(table.column("dictionary").to_pylist()) == {"alpha", "beta", "gamma", None}
    np.testing.assert_array_equal(table.column("f64").to_numpy(), col_f64 := ref.column("f64").to_numpy())
    assert col_f64.dtype == table.column("f64").to_numpy().dtype


def test_arrow_reader_field_metadata():
    """The POD5 extension types arrive as their storage with the extension's
    name in the field metadata."""
    meta = {"ARROW:extension:name": "minknow.uuid", "ARROW:extension:metadata": ""}
    schema = pa.schema([pa.field("read_id", pa.binary(16), metadata=meta)])
    data = _ipc([pa.record_batch([pa.array([b"\x01" * 16], pa.binary(16))], schema=schema)])
    f = arrow_ipc.read_file(data).column("read_id").field
    assert f.metadata == meta and f.type.byte_width == 16 and f.type.name == "FixedSizeBinary"


def test_arrow_reader_refuses_what_it_does_not_decode():
    words: list[str] = []
    with pytest.raises(arrow_ipc.ArrowUnsupported, match="compressed"):
        arrow_ipc.read_file(_ipc([_batch(5, 0, words)], compression="zstd"))
    for array in (pa.array([1, 2], pa.decimal128(5, 2)), pa.array([1, 2], pa.date32()),
                  pa.array([[1], [2]], pa.large_list(pa.int8())), pa.nulls(2)):
        data = _ipc([pa.record_batch([array], names=["c"])])
        with pytest.raises(arrow_ipc.ArrowUnsupported, match=r"Arrow type \w+ is not supported"):
            arrow_ipc.read_file(data)
    with pytest.raises(arrow_ipc.ArrowInvalid, match="ARROW1"):
        arrow_ipc.read_file(b"PAR1" + b"\x00" * 64)
    good = _ipc([pa.record_batch([pa.array([1, 2, 3], pa.int64())], names=["c"])])
    with pytest.raises(arrow_ipc.ArrowInvalid):
        arrow_ipc.read_file(good[:-14] + b"\xff\xff\xff\x7f" + good[-10:])


# ---------------------------------------------------------------------------
# BAM and SAM read back
# ---------------------------------------------------------------------------


def _records(n: int) -> list[SamRecord]:
    rs = np.random.RandomState(5)
    out = []
    for i in range(n):
        seq = "".join(rs.choice(list("ACGT"), rs.randint(0, 400)))
        qual = (rs.randint(0, 60, len(seq)) + 33).astype(np.uint8).tobytes().decode()
        tags = [SamTag("qs", "f", float(rs.rand() * 20)), SamTag("ns", "i", int(rs.randint(1e6))),
                SamTag("ts", "i", -3), SamTag("st", "Z", "2023-11-14T22:13:20.000+00:00"),
                SamTag("me", "I", 2**32 - 1), SamTag("tp", "A", "P"),
                SamTag("mv", "B", rs.randint(0, 2, rs.randint(1, 50)).astype(np.uint8),
                       subtype="c")]
        if i % 3 == 1:
            tags.append(SamTag("pi", "Z", f"parent-{i}"))
        out.append(SamRecord(qname=f"read-{i}", seq=seq or "*", qual=qual or "*", tags=tags))
    return out


@pytest.mark.parametrize("fmt", ["bam", "sam"])
def test_read_records_matches_jax(tmp_path, fmt):
    """Records written by the port read back as the JAX reader reads them:
    every field and tag, over a BAM of several BGZF blocks."""
    header = SamHeader(programs=[{"ID": "basecaller", "CL": "dorado_tpu_torch basecaller m d"}])
    path = tmp_path / f"x.{fmt}"
    records = _records(400)
    with open(path, "wb" if fmt == "bam" else "w") as fh:
        writer = BamWriter(fh, header, threads=0) if fmt == "bam" else SamWriter(fh, header)
        for rec in records:
            writer.write(rec)
        writer.close()
    text, got = read_records(path)
    want_text, want = jax_read_records(path)
    assert text == want_text == header.to_text()
    assert len(got) == len(want) == len(records)
    if fmt == "bam":
        with open(path, "rb") as fh:
            assert len(list(bgzf.iter_members(fh))) > 3
    for a, b in zip(got, want):
        assert (a.qname, a.flag, a.rname, a.pos, a.mapq, a.cigar, a.seq, a.qual) == (
            b.qname, b.flag, b.rname, b.pos, b.mapq, b.cigar, b.seq, b.qual)
        assert [(t.tag, t.type, t.subtype) for t in a.tags] == [
            (t.tag, t.type, t.subtype) for t in b.tags]
        for ta, tb in zip(a.tags, b.tags):
            np.testing.assert_array_equal(ta.value, tb.value)
    assert [r.seq for r in got] == [r.seq for r in records]


def test_read_records_refuses_cram(tmp_path):
    """A reference-based CRAM needs its contig, which ``read_records`` is not
    given (as in the JAX package): ValueError naming it. A non-reference
    CRAM reads (``tests/test_torch_cram.py``)."""
    from tests.torch_cram import rr_cram

    path = tmp_path / "x.cram"
    refs = rr_cram(path)
    with pytest.raises(ValueError, match="RR=true slice needs ref_seqs\\['ctg'\\]"):
        read_records(path)
    from dorado_tpu_torch.io.cram import CramReader

    assert len(list(CramReader(path, ref_seqs=refs).records())) == 4


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_empty_array_tag_round_trips(tmp_path, fmt):
    """A record whose ML array is empty (a duplex read with no site called)
    writes ``ML:B:C`` in SAM, and both packages' readers give back an empty
    array, from SAM and from BAM."""
    rec = SamRecord(qname="t;c", seq="ACGT", qual="++++", tags=[
        SamTag("MM", "Z", "C+h?;"), SamTag("ML", "B", np.zeros(0, np.uint8), subtype="C"),
        SamTag("MN", "i", 4)])
    assert rec.tag_string(rec.tags[1]) == "ML:B:C"
    path = tmp_path / f"out.{fmt}"
    with open(path, "w" if fmt == "sam" else "wb") as fh:
        writer = (SamWriter if fmt == "sam" else BamWriter)(fh, SamHeader())
        writer.write(rec)
        writer.close()
    for reader in (read_records, jax_read_records):
        (got,) = reader(path)[1]
        ml = next(t for t in got.tags if t.tag == "ML")
        assert len(ml.value) == 0 and ml.subtype == "C"
        assert [t.tag for t in got.tags] == ["MM", "ML", "MN"]
