"""The port's simplex pipeline (``run_reads``, CPU) against the JAX
``BasecallerPipeline.run`` on the same synthetic reads, both splitting reads
(their default), with the Viterbi and the beam decoder on a narrow hac model,
and with the Viterbi decoder on the small transformer (sup) model; with each
read filter (``min_qscore``, ``only_read_ids``, ``skip_read_ids``,
``max_reads``); and both pipelines' finishers on one stitched call of a
planted concatemer, where the split fires.

The JAX pipeline reads POD5 files; the test hands it the same reads by
replacing ``find_pod5_files`` and ``Pod5File`` in its module's namespace.
Records must agree exactly except for the quality string and the ``qs`` tag
derived from it, which follow the runner test's tolerance.
"""

import io
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dorado_tpu.pipeline.basecaller as jax_pipeline_module
from dorado_tpu.io import pod5 as jax_pod5
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.models.presets import sup_v50_config as jax_sup_config
import dorado_tpu_torch.pipeline.basecaller as port_pipeline_module
from dorado_tpu_torch.io import pod5
from dorado_tpu_torch.io.bgzf import BGZF_EOF
from dorado_tpu_torch.io.sam import BamWriter, SamTag
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config, sup_v50_config
from dorado_tpu_torch.models.tx_model import tx_params_from_jax
from dorado_tpu_torch.pipeline import BasecallerPipeline
from tests.test_torch_runner import _narrow_hac, assert_qstrings_close, jax_params_with_moves
from tests.test_torch_tx_model import jax_tx_params, small_sup
from tests.torch_concatemers import concatemer

FILENAME = "synthetic.pod5"
LENGTHS = [3000, 890, 5200, 1700]


def _reads(module):
    rs = np.random.RandomState(9)
    run_info = module.RunInfo(
        acquisition_id="acq0", sample_rate=5000, flow_cell_id="FAB00000",
        flow_cell_product_code="FLO-PRO114M", protocol_run_id="run0",
        acquisition_start_time_ms=1_700_000_000_000, sample_id="sample0",
    )
    reads = []
    for i, n in enumerate(LENGTHS):
        # raw ADC around the hac standardisation mean (91.88 pA at 0.2 pA/ADC)
        signal = np.clip(rs.normal(460, 113, n), -32768, 32767).astype(np.int16)
        reads.append(module.Pod5Read(
            read_id=f"read-{i}", signal=signal, read_number=i, start_sample=1000 * i,
            median_before=200.0, channel=i + 1, well=1, pore_type="not_set",
            calibration_offset=0.0, calibration_scale=0.2,
            end_reason="mux_change" if i == 2 else "signal_positive",
            end_reason_forced=False, open_pore_level=float("nan"),
            num_reads_since_mux_change=0, time_since_mux_change=0.0,
            num_minknow_events=10 * i, tracked_scaling_scale=float("nan"),
            tracked_scaling_shift=float("nan"), predicted_scaling_scale=float("nan"),
            predicted_scaling_shift=float("nan"), run_info=run_info, filename=FILENAME,
        ))
    return reads


class _Collect:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


class _FakePod5File:
    reads_skipped = 0

    def __init__(self, path):
        self.path = path

    def reads(self):
        return iter(_reads(jax_pod5))


def _jax_run(jp):
    """``jp.run`` over the synthetic reads: its records."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_pipeline_module, "find_pod5_files", lambda *a, **k: [Path(FILENAME)])
    mp.setattr(jax_pipeline_module, "Pod5File", _FakePod5File)
    try:
        ref = _Collect()
        jp.run("unused", ref)
    finally:
        mp.undo()
    return ref.records


def _run_both(decoder, family="hac"):
    """The same reads through the JAX pipeline and the port's, both splitting
    reads: (JAX records, the port's records, the port's stats)."""
    if family == "hac":
        params = jax_params_with_moves(2)
        jcfg, cfg = _narrow_hac(jax_hac_config()), _narrow_hac(hac_v43_config())
        model = params_from_jax(params, cfg)
        chunk_size = 1200
    else:
        params = jax_tx_params(3)
        jcfg, cfg = small_sup(jax_sup_config()), small_sup(sup_v50_config())
        model = tx_params_from_jax(params, cfg)
        chunk_size = 1152
    kw = dict(chunk_size=chunk_size, batch_size=8, emit_moves=True, decoder=decoder)
    jp = jax_pipeline_module.BasecallerPipeline(jcfg, params, compute_dtype=jnp.float32, **kw)
    ref = _jax_run(jp)
    tp = BasecallerPipeline(cfg, model, device="cpu", **kw)
    assert tp.read_splitter.settings.simplex_mode and tp.read_splitter.settings.pore_thr == 2.8
    out = _Collect()
    stats = tp.run_reads(_reads(pod5), out)
    return ref, out.records, stats


@pytest.fixture(scope="module")
def records():
    return _run_both("viterbi")


@pytest.fixture(scope="module")
def beam_records():
    return _run_both("beam")


def _assert_tx_qstrings_close(a: str, b: str, counts: list) -> None:
    """The transformer runner test's rule: one step, or up to 3 where both
    chars are at phred 40 or more."""
    qa = np.frombuffer(a.encode(), np.uint8).astype(np.int32) - 33
    qb = np.frombuffer(b.encode(), np.uint8).astype(np.int32) - 33
    assert len(qa) == len(qb)
    assert np.abs(qa - qb).max(initial=0) <= 3
    assert np.all(np.minimum(qa, qb)[np.abs(qa - qb) > 1] >= 40)
    counts[0] += int((qa != qb).sum())
    counts[1] += len(qa)


def _assert_records_match(
    ref, out, stats, qstrings_close=assert_qstrings_close, max_share_different=0.01,
    names=tuple(f"read-{i}" for i in range(4)), min_positions=500, min_batches=2,
):
    # both pipelines write reads in the order they complete
    assert [r.qname for r in out] == [r.qname for r in ref]
    assert sorted(r.qname for r in out) == list(names)
    counts = [0, 0]
    for a, b in zip(ref, out):
        assert b.seq == a.seq and b.flag == a.flag
        qstrings_close(b.qual, a.qual, counts)
        ta = {t.tag: t for t in a.tags}
        tb = {t.tag: t for t in b.tags}
        assert [t.tag for t in b.tags] == [t.tag for t in a.tags]
        for tag in ta:
            if tag == "qs":
                assert tb[tag].value == pytest.approx(ta[tag].value, rel=1e-2)
            elif tag == "mv":
                np.testing.assert_array_equal(tb[tag].value, ta[tag].value)
            else:
                a_t, b_t = ta[tag], tb[tag]
                assert (b_t.type, b_t.value, b_t.subtype) == (a_t.type, a_t.value, a_t.subtype), tag
    assert counts[1] > min_positions
    assert counts[0] <= max_share_different * counts[1]
    assert stats.reads_called == len(names) and stats.batches >= min_batches
    assert stats.bases_called == sum(len(r.seq) for r in out)


def test_records_match_jax(records):
    _assert_records_match(*records)


def test_beam_records_match_jax(beam_records, records):
    """``decoder="beam"`` writes the JAX beam pipeline's records, and they
    are not the Viterbi pipeline's."""
    _assert_records_match(*beam_records)
    assert [r.seq for r in beam_records[1]] != [r.seq for r in records[1]]


def test_tx_records_match_jax():
    """A transformer model runs through ``run_reads`` to the JAX pipeline's
    records: sequences, moves and every tag but ``qs`` equal; qual chars
    differ at no more than 2% of these 1667 positions (measured: 18)."""
    ref, out, stats = _run_both("viterbi", family="sup")
    _assert_records_match(ref, out, stats, _assert_tx_qstrings_close, 0.02)
    header = {t.tag: t.value for t in out[0].tags}
    assert header["RG"].endswith("dna_r10.4.1_e8.2_400bps_sup@v5.0.0")


def test_pipeline_passes_decoder_and_precision_through():
    cfg = _narrow_hac(hac_v43_config())
    model = params_from_jax(jax_params_with_moves(2), cfg)
    tp = BasecallerPipeline(cfg, model, device="cpu", decoder="beam", lstm_precision="w8a8")
    assert (tp.runner.decoder, tp.runner.lstm_precision) == ("beam", "w8a8")
    with pytest.raises(ValueError, match="unknown decoder"):
        BasecallerPipeline(cfg, model, device="cpu", decoder="beam-host")
    sup = small_sup(sup_v50_config())
    tp = BasecallerPipeline(
        sup, tx_params_from_jax(jax_tx_params(3), sup), device="cpu", tx_precision="w8a8"
    )
    assert (tp.runner.decoder, tp.runner.tx_precision) == ("viterbi", "w8a8")
    assert tp.runner.model.layers[0].fc2_q.dtype == torch.int8


def test_bam_output(records):
    _, out, _ = records
    cfg = _narrow_hac(hac_v43_config())
    tp = BasecallerPipeline(cfg, params_from_jax(jax_params_with_moves(2), cfg), device="cpu")
    buf = io.BytesIO()
    writer = BamWriter(buf, tp.build_header([r.run_info for r in _reads(pod5)]), threads=0)
    for rec in out:
        writer.write(rec)
    writer.close()
    data = buf.getvalue()
    assert data[:4] == b"\x1f\x8b\x08\x04" and data.endswith(BGZF_EOF)
    assert writer.records_written == len(LENGTHS)



@pytest.fixture(scope="module")
def pipelines():
    """One JAX and one port pipeline on the narrow hac model, reused by the
    filter tests, which set the filters' attributes before each run."""
    params = jax_params_with_moves(2)
    cfg = _narrow_hac(hac_v43_config())
    kw = dict(chunk_size=1200, batch_size=8, emit_moves=True)
    jp = jax_pipeline_module.BasecallerPipeline(
        _narrow_hac(jax_hac_config()), params, compute_dtype=jnp.float32, **kw)
    return jp, BasecallerPipeline(cfg, params_from_jax(params, cfg), device="cpu", **kw)


def _min_qscore_between(records):
    """A threshold halfway across the widest gap between two reads' qs: the
    two frameworks' qs (1% apart at most) fall on the same side of it."""
    qs = sorted(float(next(t.value for t in r.tags if t.tag == "qs")) for r in records)
    gap, i = max((b - a, i) for i, (a, b) in enumerate(zip(qs, qs[1:])))
    assert gap > 0.05 * qs[i + 1]
    return (qs[i] + qs[i + 1]) / 2, i + 1


@pytest.mark.parametrize("which", ["min_qscore", "only_read_ids", "skip_read_ids", "max_reads"])
def test_read_filters_match_jax(pipelines, records, which):
    """Each filter keeps the same records in both pipelines, and counts the
    same ``reads_filtered``; only the admitted reads are decoded."""
    jp, tp = pipelines
    threshold, n_below = _min_qscore_between(records[0])
    setting = {
        "min_qscore": threshold,
        "only_read_ids": {"read-1", "read-3", "not-in-the-input"},
        "skip_read_ids": {"read-0", "read-2"},
        "max_reads": 2,
    }[which]
    for p in (jp, tp):
        p.min_qscore, p.skip_read_ids, p.only_read_ids, p.max_reads = 0.0, set(), None, None
        setattr(p, which, setting)
        p._reads_fed = p.reads_filtered = 0
    ref = _jax_run(jp)
    out = _Collect()
    taken = []

    def source():
        for r in _reads(pod5):
            taken.append(r.read_id)
            yield r

    stats = tp.run_reads(source(), out)
    names = {
        "min_qscore": sorted(r.qname for r in records[0]
                             if next(t.value for t in r.tags if t.tag == "qs") > threshold),
        "only_read_ids": ["read-1", "read-3"],
        "skip_read_ids": ["read-1", "read-3"],
        "max_reads": ["read-0", "read-1"],
    }[which]
    _assert_records_match(ref, out.records, stats, names=tuple(names), min_positions=100,
                          min_batches=1)
    assert tp.reads_filtered == jp.reads_filtered == (n_below if which == "min_qscore" else 0)
    assert taken == (["read-0", "read-1"] if which == "max_reads" else [f"read-{i}" for i in range(4)])
    assert tp.run_reads(_reads(pod5), _Collect()).reads_called == (
        0 if which == "max_reads" else len(names))


def _split_call(module, c, read):
    """A working read of ``module``'s pipeline whose one chunk was called as
    the planted concatemer ``c``."""
    n = len(c.signal)
    call = SimpleNamespace(sequence=c.seq, qstring=c.qstring, moves=c.moves)
    return module._WorkingRead(
        read=read, scaled=c.signal.copy(), num_trimmed=10, shift_pa=91.9, scale_pa=22.5,
        scaling_method="quantile", offsets=[0], chunk_sizes=[n], results=[call], pending=0)


def test_split_records_match_jax(pipelines):
    """Both finishers on one stitched call of a planted concatemer (three
    strands, adapters at both junctions) write the same three subread
    records, tag for tag: ``:i`` names, ``pi``, ``sp:i:0``, ``rn = -1`` and the
    subread's ``ns``, ``ts = 0`` and ``du``."""
    jp, tp = pipelines
    for p in (jp, tp):
        p.min_qscore, p.skip_read_ids, p.only_read_ids, p.max_reads = 0.0, set(), None, None
    c = concatemer(np.random.RandomState(4), [1500, 2200, 1800], 6, duplex=False)
    want = jp._finish_read(_split_call(jax_pipeline_module, c, _reads(jax_pod5)[1]))
    got = tp._finish_read(_split_call(port_pipeline_module, c, _reads(pod5)[1]))
    assert [r.qname for r in got] == [r.qname for r in want] == ["read-1:0", "read-1:1",
                                                                 "read-1:2"]
    assert [r.seq for r in got] == c.pieces(c.junctions)
    for a, b in zip(want, got):
        assert (b.seq, b.qual, b.flag) == (a.seq, a.qual, a.flag)
        assert [(t.tag, t.type, t.value, t.subtype) for t in b.tags if t.tag != "mv"] == [
            (t.tag, t.type, t.value, t.subtype) for t in a.tags if t.tag != "mv"]
        np.testing.assert_array_equal(next(t.value for t in b.tags if t.tag == "mv"),
                                      next(t.value for t in a.tags if t.tag == "mv"))
        tags = {t.tag: t.value for t in b.tags}
        assert (tags["pi"], tags["sp"], tags["rn"], tags["ts"]) == ("read-1", 0, -1, 0)
    ns = [dict((t.tag, t.value) for t in r.tags)["ns"] for r in got]
    assert sum(ns) < len(c.signal) and min(ns) > 0


def test_modbase_records_match_jax(tmp_path):
    """Both pipelines with a modified-base caller on one narrow 5mCG_5hmCG@v3
    model directory (``tests/test_torch_modbase.py``'s, rescale on): the
    records match tag for tag, MN/MM/ML after ``me``; MM equal, ML values
    within 1 and equal at 99.9% of them (the floor of p * 256 of float32 sums
    in another order), and ML non-empty on both sides."""
    from dorado_tpu.modbase.caller import ModBaseCaller as JaxModBaseCaller
    from dorado_tpu.modbase.config import load_modbase_config as jax_load_modbase_config
    from dorado_tpu_torch.modbase.caller import ModBaseCaller
    from dorado_tpu_torch.modbase.config import load_modbase_config
    from dorado_tpu_torch.modbase.model import init_modbase_params, save_modbase_model
    from dorado_tpu_torch.models.presets import hac_5mcg_5hmcg_v3_config

    mod_cfg = hac_5mcg_5hmcg_v3_config(32)
    levels = np.random.RandomState(5).randn(4**mod_cfg.kmer_len).astype(np.float32)
    mod_dir = save_modbase_model(mod_cfg, init_modbase_params(mod_cfg, torch.Generator()
                                                              .manual_seed(3)),
                                 tmp_path / mod_cfg.model_path.name, refine_levels=levels)
    params = jax_params_with_moves(2)
    cfg = _narrow_hac(hac_v43_config())
    kw = dict(chunk_size=1200, batch_size=8, emit_moves=True, modbase_threshold=0.1)
    jp = jax_pipeline_module.BasecallerPipeline(
        _narrow_hac(jax_hac_config()), params, compute_dtype=jnp.float32,
        modbase_caller=JaxModBaseCaller([jax_load_modbase_config(mod_dir)], canonical_stride=6,
                                        batch_size=16), **kw)
    ref = _jax_run(jp)
    tp = BasecallerPipeline(
        cfg, params_from_jax(params, cfg), device="cpu",
        modbase_caller=ModBaseCaller([load_modbase_config(mod_dir)], canonical_stride=6,
                                     batch_size=16, device="cpu"), **kw)
    out = _Collect()
    stats = tp.run_reads(_reads(pod5), out)
    ml_ref = [next(t for t in r.tags if t.tag == "ML").value for r in ref]
    ml_out = [next(t for t in r.tags if t.tag == "ML").value for r in out.records]
    strip = [[SamTag(t.tag, t.type, 0, t.subtype) if t.tag == "ML" else t for t in r.tags]
             for r in out.records]
    for r, t in zip(out.records, strip):
        assert [x.tag for x in r.tags][-4:] == ["me", "MN", "MM", "ML"]
        r.tags = t
    for r in ref:
        r.tags = [SamTag(t.tag, t.type, 0, t.subtype) if t.tag == "ML" else t for t in r.tags]
    _assert_records_match(ref, out.records, stats)
    got, want = np.concatenate(ml_out), np.concatenate(ml_ref)
    assert len(got) == len(want) > 20
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
