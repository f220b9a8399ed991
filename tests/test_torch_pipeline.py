"""The port's simplex pipeline (``run_reads``, CPU) against the JAX
``BasecallerPipeline(split_reads=False).run`` on the same synthetic reads,
with the Viterbi and the beam decoder.

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

import dorado_tpu.pipeline.basecaller as jax_pipeline_module
from dorado_tpu.io import pod5 as jax_pod5
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu_torch.io import pod5
from dorado_tpu_torch.io.bgzf import BGZF_EOF
from dorado_tpu_torch.io.sam import BamWriter
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import hac_v43_config
from dorado_tpu_torch.pipeline import BasecallerPipeline
from tests.test_torch_runner import _narrow_hac, assert_qstrings_close, jax_params_with_moves

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


def _run_both(decoder):
    """The same reads through the JAX pipeline and the port's: (JAX records,
    the port's records, the port's stats)."""
    params = jax_params_with_moves(2)
    kw = dict(chunk_size=1200, batch_size=8, emit_moves=True, decoder=decoder)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_pipeline_module, "find_pod5_files", lambda *a, **k: [Path(FILENAME)])
    mp.setattr(jax_pipeline_module, "Pod5File", _FakePod5File)
    try:
        jp = jax_pipeline_module.BasecallerPipeline(
            _narrow_hac(jax_hac_config()), params, split_reads=False,
            compute_dtype=jnp.float32, **kw,
        )
        ref = _Collect()
        jp.run("unused", ref)
    finally:
        mp.undo()
    cfg = _narrow_hac(hac_v43_config())
    tp = BasecallerPipeline(cfg, params_from_jax(params, cfg), device="cpu", **kw)
    out = _Collect()
    stats = tp.run_reads(_reads(pod5), out)
    return ref.records, out.records, stats


@pytest.fixture(scope="module")
def records():
    return _run_both("viterbi")


@pytest.fixture(scope="module")
def beam_records():
    return _run_both("beam")


def _assert_records_match(ref, out, stats):
    # both pipelines write reads in the order they complete
    assert [r.qname for r in out] == [r.qname for r in ref]
    assert sorted(r.qname for r in out) == [f"read-{i}" for i in range(4)]
    counts = [0, 0]
    for a, b in zip(ref, out):
        assert b.seq == a.seq and b.flag == a.flag
        assert_qstrings_close(b.qual, a.qual, counts)
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
    assert counts[0] <= 0.01 * counts[1]
    assert stats.reads_called == 4 and stats.batches >= 2
    assert stats.bases_called == sum(len(r.seq) for r in out)


def test_records_match_jax(records):
    _assert_records_match(*records)


def test_beam_records_match_jax(beam_records, records):
    """``decoder="beam"`` writes the JAX beam pipeline's records, and they
    are not the Viterbi pipeline's."""
    _assert_records_match(*beam_records)
    assert [r.seq for r in beam_records[1]] != [r.seq for r in records[1]]


def test_pipeline_passes_decoder_and_precision_through():
    cfg = _narrow_hac(hac_v43_config())
    model = params_from_jax(jax_params_with_moves(2), cfg)
    tp = BasecallerPipeline(cfg, model, device="cpu", decoder="beam", lstm_precision="w8a8")
    assert (tp.runner.decoder, tp.runner.lstm_precision) == ("beam", "w8a8")
    with pytest.raises(ValueError, match="unknown decoder"):
        BasecallerPipeline(cfg, model, device="cpu", decoder="beam-host")


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

