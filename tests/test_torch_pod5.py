"""The port's POD5 reader (``io/pod5.py``: its own Arrow reader and VBZ
codec) against the JAX package's (pyarrow and zstandard) on files that
``tests/torch_pod5_writer.py`` writes, and on the committed fixture."""

import dataclasses
import math

import numpy as np
import pytest

from dorado_tpu.io import pod5 as jax_pod5
from dorado_tpu_torch.io import pod5
from tests.torch_pod5_writer import FIXTURE, fixture_reads, make_reads, run_info, write_pod5


def _assert_reads_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.keys() == db.keys()
        for key, va in da.items():
            vb = db[key]
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype == np.int16, key
                np.testing.assert_array_equal(va, vb)
            elif isinstance(vb, float) and math.isnan(vb):
                assert math.isnan(va), key
            else:
                assert va == vb and type(va) is type(vb), (key, va, vb)


def _assert_run_infos_equal(ours, theirs):
    assert [dataclasses.asdict(r) for r in ours] == [dataclasses.asdict(r) for r in theirs]


def test_fixture_matches_jax_reader():
    ours, theirs = pod5.Pod5File(FIXTURE), jax_pod5.Pod5File(FIXTURE)
    assert ours.num_reads == theirs.num_reads == 16
    assert ours.read_ids() == theirs.read_ids()
    _assert_run_infos_equal(ours.run_infos, theirs.run_infos)
    _assert_reads_equal(list(ours.reads()), list(theirs.reads()))
    assert ours.reads_skipped == 0


def test_fixture_decodes_to_the_writers_reads():
    """Both readers give back the reads the writer made from its seed."""
    reads, infos = fixture_reads()
    assert FIXTURE.stat().st_size < 1 << 20
    assert all(3_000 <= len(r["signal"]) <= 60_000 for r in reads)
    for module in (pod5, jax_pod5):
        got = list(module.Pod5File(FIXTURE).reads())
        assert [g.read_id for g in got] == [str(r["read_id"]) for r in reads]
        for g, r in zip(got, reads):
            np.testing.assert_array_equal(g.signal, r["signal"])
            assert g.channel == r["channel"] and g.end_reason == r["end_reason"]
            assert g.pore_type == r["pore_type"] and g.run_info.acquisition_id == r["run_info"]
            ors = r["open_pore_level"]
            assert (math.isnan(g.open_pore_level) if ors is None
                    else g.open_pore_level == pytest.approx(ors))
        assert [ri.protocol_run_id for ri in module.Pod5File(FIXTURE).run_infos] == [
            i["protocol_run_id"] for i in infos]


@pytest.fixture(scope="module")
def two_files(tmp_path_factory):
    """Two files of one run, one with a corrupt signal row."""
    d = tmp_path_factory.mktemp("pod5")
    infos = [run_info(5, rate=4000)]
    write_pod5(d / "a.pod5", make_reads(1, [900, 20_000, 5_000, 12], infos), infos, batch_reads=3)
    write_pod5(d / "b.pod5", make_reads(2, [4_000, 7_000, 300], infos), infos, batch_reads=2,
               corrupt_reads=(1,))
    return d


def test_reads_match_jax_and_skip_a_corrupt_row(two_files):
    for name, skipped in (("a.pod5", 0), ("b.pod5", 1)):
        ours, theirs = pod5.Pod5File(two_files / name), jax_pod5.Pod5File(two_files / name)
        _assert_reads_equal(list(ours.reads()), list(theirs.reads()))
        assert ours.reads_skipped == theirs.reads_skipped == skipped
        _assert_run_infos_equal(ours.run_infos, theirs.run_infos)
        for i in range(ours.num_reads):
            if (name, i) == ("b.pod5", 1):
                with pytest.raises(ValueError, match="corrupt VBZ"):
                    ours.get_read(i)
            else:
                _assert_reads_equal([ours.get_read(i)], [theirs.get_read(i)])
    with pytest.raises(ValueError, match="corrupt VBZ"):
        list(pod5.Pod5File(two_files / "b.pod5").reads(strict=True))


def test_iter_reads_and_channel_order_match_jax(two_files):
    files = pod5.find_pod5_files(two_files)
    assert files == jax_pod5.find_pod5_files(two_files) == [two_files / "a.pod5", two_files / "b.pod5"]
    # file order: the corrupt row skipped
    ours, theirs = list(pod5.iter_reads(files)), list(jax_pod5.iter_reads(files))
    assert len(ours) == 6
    _assert_reads_equal(ours, theirs)
    # channel order across files (a clean file and itself again)
    clean = [files[0], files[0]]
    ours = list(pod5.iter_reads(clean, by_channel=True))
    _assert_reads_equal(ours, list(jax_pod5.iter_reads(clean, by_channel=True)))
    keys = [(r.channel, r.start_sample) for r in ours]
    assert len(keys) == 8 and keys == sorted(keys)
    # the channel-ordered walk does not skip: a corrupt row raises in both
    for module in (pod5, jax_pod5):
        with pytest.raises(Exception, match="corrupt VBZ|decompress"):
            list(module.iter_reads(files, by_channel=True))


def test_find_pod5_files_rejects_fast5(tmp_path):
    (tmp_path / "x.fast5").write_bytes(b"")
    with pytest.raises(RuntimeError, match="FAST5 files are not supported"):
        pod5.find_pod5_files(tmp_path)
    assert pod5.find_pod5_files(tmp_path / "missing") == []
    nested = tmp_path / "sub" / "deeper"
    nested.mkdir(parents=True)
    (nested / "r.pod5").write_bytes(b"")
    assert pod5.find_pod5_files(tmp_path, recursive=True) == [nested / "r.pod5"]


def test_not_a_pod5_file(tmp_path):
    (tmp_path / "bad.pod5").write_bytes(b"\x00" * 100)
    with pytest.raises(ValueError, match="not a POD5 file"):
        pod5.Pod5File(tmp_path / "bad.pod5")
