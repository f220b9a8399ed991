"""Direct-RNA basecalling: the port's ``BasecallerPipeline`` (``run_reads``,
CPU) against the JAX pipeline on the same synthetic RNA reads and the same
narrow weights (a conv+LSTM model written with the ``rna004`` sample type),
both splitting reads (their default): the RNA signal split at open-pore
spikes (subread ids, ``rn`` -1), the DNA adapter trim (``ts``/``ns``), the
3'->5' reversal of the calls, the mean q-score over the bases before the
poly(A) tail, poly(A) estimation (``pt``/``pa``), the q-score filter,
modified bases on an RNA model, the RNA adapter trim forced on a DNA model
(``force_rna_adapter_trim``, the CLI's ``--rna-adapters``), and the
basecaller command on an RNA model directory against the JAX command.

Records must agree exactly except for the quality string and the ``qs`` tag
derived from it, which follow the runner test's tolerance (ROADMAP queue 3)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dorado_tpu.pipeline.basecaller as jax_pipeline_module
from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.config import SampleType as JaxSampleType
from dorado_tpu.io import pod5 as jax_pod5
from dorado_tpu.io.bam_reader import read_records as jax_read_records
from dorado_tpu.models.load import save_lstm_params as jax_save_lstm_params
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
import dorado_tpu_torch.pipeline.basecaller as port_module
from dorado_tpu_torch.cli.main import main
from dorado_tpu_torch.io import pod5
from dorado_tpu_torch.io.bam_reader import read_records
from dorado_tpu_torch.io.sam import SamTag
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import config_toml, hac_v43_config, rna004_hac_config
from dorado_tpu_torch.pipeline import BasecallerPipeline
from tests.test_torch_pipeline import _assert_records_match as _assert_pipeline_records_match
from tests.test_torch_runner import _narrow_hac, jax_params_with_moves
from tests.torch_rna import rna_signals

LENGTHS = [6000, 9000, 5200, 4000, 7500]
RNA_NAME = "rna004_130bps_hac@v5.0.0"
KW = dict(chunk_size=1200, batch_size=8, emit_moves=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, from before the module's fixtures run: several test
    workers share the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _jax_rna_config():
    cfg = _narrow_hac(jax_hac_config())
    cfg.model_path = Path(RNA_NAME)
    cfg.sample_type = JaxSampleType.RNA004
    cfg.sample_rate = 4000
    return cfg


def _reads(module, signals=None):
    run_info = module.RunInfo(
        acquisition_id="acq0", sample_rate=4000, flow_cell_id="FAL00000",
        flow_cell_product_code="FLO-MIN004RA", protocol_run_id="run0",
        acquisition_start_time_ms=1_700_000_000_000, sample_id="sample0",
    )
    return [module.Pod5Read(
        read_id=f"read-{i}", signal=signal, read_number=i, start_sample=1000 * i,
        median_before=200.0, channel=i + 1, well=1, pore_type="not_set",
        calibration_offset=0.0, calibration_scale=0.2,
        end_reason="mux_change" if i == 2 else "signal_positive",
        end_reason_forced=False, open_pore_level=float("nan"), num_reads_since_mux_change=0,
        time_since_mux_change=0.0, num_minknow_events=10 * i,
        tracked_scaling_scale=float("nan"), tracked_scaling_shift=float("nan"),
        predicted_scaling_scale=float("nan"), predicted_scaling_shift=float("nan"),
        run_info=run_info, filename="rna.pod5",
    ) for i, signal in enumerate(signals or rna_signals(11, LENGTHS))]


class _Collect:
    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)


def _run_both(jcfg, cfg, jax_kw=None, port_kw=None, signals=None):
    """The same reads through the JAX pipeline (``run`` over a patched
    POD5 source) and the port's ``run_reads``: (JAX records, the port's
    records, the port's stats, the port's pipeline)."""
    params = jax_params_with_moves(2)

    class FakePod5File:
        reads_skipped = 0

        def __init__(self, path):
            pass

        def reads(self):
            return iter(_reads(jax_pod5, signals))

    jp = jax_pipeline_module.BasecallerPipeline(jcfg, params, compute_dtype=jnp.float32,
                                                **KW, **(jax_kw or {}))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_pipeline_module, "find_pod5_files", lambda *a, **k: [Path("rna.pod5")])
    mp.setattr(jax_pipeline_module, "Pod5File", FakePod5File)
    try:
        ref = _Collect()
        jp.run("unused", ref)
    finally:
        mp.undo()
    tp = BasecallerPipeline(cfg, params_from_jax(params, cfg), device="cpu", **KW,
                            **(port_kw or {}))
    out = _Collect()
    stats = tp.run_reads(_reads(pod5, signals), out)
    return ref.records, out.records, stats, tp


@pytest.fixture(scope="module")
def poly_a_records():
    cfg = _narrow_hac(rna004_hac_config())
    return _run_both(_jax_rna_config(), cfg, dict(estimate_poly_a=True),
                     dict(estimate_poly_a=True))


def _names(records):
    return tuple(sorted(r.qname for r in records))


def _arrays_to_tuples(*record_lists):
    """Array tags but ``mv`` (``pa``) as tuples, which compare by value."""
    for recs in record_lists:
        for r in recs:
            for t in r.tags:
                if t.type == "B" and t.tag != "mv":
                    t.value = tuple(np.atleast_1d(t.value).tolist())


def _assert_records_match(ref, out, stats, **kw):
    """``tests/test_torch_pipeline.py``'s rule, with array tags compared by
    value."""
    _arrays_to_tuples(ref, out)
    _assert_pipeline_records_match(ref, out, stats, **kw)


def test_rna_records_match_jax(poly_a_records):
    """Split subreads, the adapter trim, the reversal, q-scores and pt/pa
    equal the JAX pipeline's; the port's pipeline holds the RNA splitter and
    no DNA splitter."""
    ref, out, stats, tp = poly_a_records
    assert tp.rna_splitter is not None and tp.read_splitter is None
    _assert_records_match(ref, out, stats, names=_names(ref), min_batches=2)
    tags = [{t.tag: t.value for t in r.tags} for r in out]
    split = [t for r, t in zip(out, tags) if ":" in r.qname]
    assert split and all(t["rn"] == -1 for t in split)
    assert all("pi" not in t for t in tags)  # an RNA split names its subreads only
    assert sum(t["ts"] > 0 for t in tags) >= 3 and all("pt" in t and "pa" in t for t in tags)
    assert all(t["RG"].endswith(RNA_NAME) for t in tags)


def test_rna_calls_are_reversed(poly_a_records):
    """The calls are written 5'->3': the finisher's stitched call, trimmed
    at a mux change, reversed (bases, qualities and moves)."""
    _, out, _, tp = poly_a_records
    rec = out[0]
    seen = {}
    real = port_module.mux_change_trim

    def keep(seq, qstring, moves, signal, stride, end_reason):
        got = real(seq, qstring, moves, signal, stride, end_reason)
        seen["call"] = got
        return got

    mp = pytest.MonkeyPatch()
    mp.setattr(port_module, "mux_change_trim", keep)
    try:
        again = _Collect()
        tp.run_reads(_reads(pod5)[:1], again)
    finally:
        mp.undo()
    seq, qstring, moves, _ = seen["call"]
    first = again.records[-1]
    assert first.seq == seq[::-1] and first.qual == qstring[::-1]
    mv = next(t.value for t in first.tags if t.tag == "mv")
    np.testing.assert_array_equal(mv[1:], np.asarray(moves)[::-1])
    assert rec.qname.startswith("read-0")


def test_rna_min_qscore_matches_jax(poly_a_records):
    """``min_qscore`` halfway through the records' q-scores drops the records
    the JAX pipeline's filter drops: the q-score of an RNA record skips its
    poly(A) tail."""
    ref, out, _, _ = poly_a_records
    qs = sorted(next(t.value for t in r.tags if t.tag == "qs") for r in ref)
    q = (qs[len(qs) // 2 - 1] + qs[len(qs) // 2]) / 2
    cfg = _narrow_hac(rna004_hac_config())
    ref_f, out_f, stats, tp = _run_both(_jax_rna_config(), cfg, dict(min_qscore=q),
                                        dict(min_qscore=q))
    assert 0 < len(out_f) < len(out) and tp.reads_filtered == len(out) - len(out_f)
    _assert_records_match(ref_f, out_f, stats, names=_names(ref_f), min_positions=100,
                          min_batches=2)


def test_rna_modbase_records_match_jax(tmp_path):
    """Modified bases on an RNA model (the callers' ``is_rna`` path) over the
    reversed calls: MN/MM/ML after ``me``, MM equal and ML within 1."""
    from dorado_tpu.modbase.caller import ModBaseCaller as JaxModBaseCaller
    from dorado_tpu.modbase.config import load_modbase_config as jax_load_modbase_config
    from dorado_tpu_torch.modbase.caller import ModBaseCaller
    from dorado_tpu_torch.modbase.config import ModificationParams, load_modbase_config
    from dorado_tpu_torch.modbase.model import init_modbase_params, save_modbase_model
    from dorado_tpu_torch.models.presets import hac_5mcg_5hmcg_v3_config

    # an m6A model on the RNA model's calls: the conv_lstm_v2 preset, narrow,
    # with one modification of A
    mod_cfg = hac_5mcg_5hmcg_v3_config(32)
    mod_cfg.model_path = Path(f"{RNA_NAME}_m6A@v1")
    mod_cfg.num_out = 2
    mod_cfg.mods = ModificationParams(codes=["a"], long_names=["6mA"], motif="A",
                                      motif_offset=0)
    levels = np.random.RandomState(5).randn(4**mod_cfg.kmer_len).astype(np.float32)
    mod_dir = save_modbase_model(mod_cfg, init_modbase_params(
        mod_cfg, torch.Generator().manual_seed(3)), tmp_path / mod_cfg.model_path.name,
        refine_levels=levels)
    signals = rna_signals(11, LENGTHS[:3])
    ref, out, stats, _ = _run_both(
        _jax_rna_config(), _narrow_hac(rna004_hac_config()),
        dict(modbase_caller=JaxModBaseCaller([jax_load_modbase_config(mod_dir)],
                                             canonical_stride=6, batch_size=16, is_rna=True),
             modbase_threshold=0.1),
        dict(modbase_caller=ModBaseCaller([load_modbase_config(mod_dir)], canonical_stride=6,
                                          batch_size=16, is_rna=True, device="cpu"),
             modbase_threshold=0.1), signals=signals)
    ml_ref = [next(t for t in r.tags if t.tag == "ML").value for r in ref]
    ml_out = [next(t for t in r.tags if t.tag == "ML").value for r in out]
    for recs in (ref, out):
        for r in recs:
            assert [t.tag for t in r.tags][-4:] == ["me", "MN", "MM", "ML"]
            r.tags = [SamTag(t.tag, t.type, 0, t.subtype) if t.tag == "ML" else t
                      for t in r.tags]
    _assert_records_match(ref, out, stats, names=_names(ref), min_positions=100,
                          min_batches=1)
    got, want = np.concatenate(ml_out), np.concatenate(ml_ref)
    assert len(got) == len(want) > 20
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_rna_adapters_on_dna_model_match_jax():
    """``force_rna_adapter_trim`` on a DNA model: the RNA adapter trim, then
    the DNA signal trim, both counted in ``ts``; the calls stay 3'->5' and
    the DNA splitter stays."""
    signals = rna_signals(12, LENGTHS[:3])
    ref, out, stats, tp = _run_both(
        _narrow_hac(jax_hac_config()), _narrow_hac(hac_v43_config()),
        dict(force_rna_adapter_trim=True), dict(force_rna_adapter_trim=True), signals=signals)
    assert tp.read_splitter is not None and tp.rna_splitter is None
    _assert_records_match(ref, out, stats, names=_names(ref), min_positions=100,
                          min_batches=1)
    plain = _Collect()
    BasecallerPipeline(tp.config, params_from_jax(jax_params_with_moves(2), tp.config),
                       device="cpu", **KW).run_reads(_reads(pod5, signals), plain)

    def ts(records):
        return {r.qname: next(t.value for t in r.tags if t.tag == "ts") for r in records
                if not any(t.tag == "pi" for t in r.tags)}

    forced, unforced = ts(out), ts(plain.records)
    assert forced.keys() == unforced.keys() and len(forced) == len(signals)
    assert all(forced[n] >= unforced[n] + 1000 for n in forced)


def test_basecaller_rna_model_directory_matches_jax(tmp_path):
    """``basecaller <rna model dir> <pod5> --estimate-poly-a --emit-sam``
    writes the JAX command's SAM but for @PG, with the RNA model's read
    group."""
    from tests.torch_pod5_writer import make_reads, run_info, write_pod5

    model = tmp_path / RNA_NAME
    model.mkdir()
    (model / "config.toml").write_text(config_toml(_narrow_hac(rna004_hac_config())))
    jax_save_lstm_params(_jax_rna_config(), jax_params_with_moves(2), model)
    infos = [run_info(4, rate=4000)]
    reads = make_reads(13, LENGTHS[:4], infos, noise=True)
    for r, signal in zip(reads, rna_signals(13, LENGTHS[:4])):
        r["signal"] = signal
    write_pod5(tmp_path / "rna.pod5", reads, infos)
    args = ["basecaller", str(model), str(tmp_path / "rna.pod5"), "-c", "1200", "-b", "8",
            "--emit-moves", "--estimate-poly-a", "--emit-sam", "-x", "cpu"]
    assert jax_main([*args, "--dtype", "float32", "-o", str(tmp_path / "j.sam")]) == 0
    assert main([*args, "-o", str(tmp_path / "t.sam")]) == 0
    jh, jrecs = jax_read_records(tmp_path / "j.sam")
    th, trecs = read_records(tmp_path / "t.sam")
    rg = [line for line in th.splitlines() if line.startswith("@RG")]
    assert rg == [line for line in jh.splitlines() if line.startswith("@RG")]
    assert RNA_NAME in rg[0]
    from tests.test_torch_cli import _assert_records_match as assert_cli_records_match

    _arrays_to_tuples(jrecs, trecs)
    assert_cli_records_match(jrecs, trecs, n_records=len(jrecs), min_positions=100)
    assert any(":" in r.qname for r in trecs)
