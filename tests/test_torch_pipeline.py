"""The port's simplex pipeline (``run_reads``, CPU) against the JAX
``BasecallerPipeline(split_reads=False).run`` on the same synthetic reads,
with the Viterbi and the beam decoder on a narrow hac model, and with the
Viterbi decoder on the small transformer (sup) model.

The JAX pipeline reads POD5 files; the test hands it the same reads by
replacing ``find_pod5_files`` and ``Pod5File`` in its module's namespace.
Records must agree exactly except for the quality string and the ``qs`` tag
derived from it, which follow the runner test's tolerance.
"""

import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dorado_tpu.pipeline.basecaller as jax_pipeline_module
from dorado_tpu.io import pod5 as jax_pod5
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.models.presets import sup_v50_config as jax_sup_config
from dorado_tpu_torch.io import pod5
from dorado_tpu_torch.io.bgzf import BGZF_EOF
from dorado_tpu_torch.io.sam import BamWriter
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config, sup_v50_config
from dorado_tpu_torch.models.tx_model import tx_params_from_jax
from dorado_tpu_torch.pipeline import BasecallerPipeline
from tests.test_torch_runner import _narrow_hac, assert_qstrings_close, jax_params_with_moves
from tests.test_torch_tx_model import jax_tx_params, small_sup

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


def _run_both(decoder, family="hac"):
    """The same reads through the JAX pipeline and the port's: (JAX records,
    the port's records, the port's stats)."""
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
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_pipeline_module, "find_pod5_files", lambda *a, **k: [Path(FILENAME)])
    mp.setattr(jax_pipeline_module, "Pod5File", _FakePod5File)
    try:
        jp = jax_pipeline_module.BasecallerPipeline(
            jcfg, params, split_reads=False, compute_dtype=jnp.float32, **kw,
        )
        ref = _Collect()
        jp.run("unused", ref)
    finally:
        mp.undo()
    tp = BasecallerPipeline(cfg, model, device="cpu", **kw)
    out = _Collect()
    stats = tp.run_reads(_reads(pod5), out)
    return ref.records, out.records, stats


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
    ref, out, stats, qstrings_close=assert_qstrings_close, max_share_different=0.01
):
    # both pipelines write reads in the order they complete
    assert [r.qname for r in out] == [r.qname for r in ref]
    assert sorted(r.qname for r in out) == [f"read-{i}" for i in range(4)]
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
    assert counts[1] > 500
    assert counts[0] <= max_share_different * counts[1]
    assert stats.reads_called == 4 and stats.batches >= 2
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

