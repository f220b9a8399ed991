"""The compute type (``compute_dtype``, the CLI's ``--dtype``) on the CPU,
the pipeline and the command line: ``BasecallerPipeline.run_reads`` against
the JAX pipeline for a narrow LSTM preset and the two-layer transformer of
``tests/test_torch_tx_model.py``, both CLIs on the committed fixture, the
CLI's default type, and ``-b 0``'s cache key, at float32 and bf16. The
tolerances are ``tests/test_torch_dtype.py``'s (the runner's): at float32
sequences and moves equal, at bf16 MIN_BF16_IDENTITY.
"""

import numpy as np
import pytest
import torch

import dorado_tpu.pipeline.basecaller as jax_pipeline_module
from dorado_tpu.cli.main import main as jax_main
from dorado_tpu.models.load import save_lstm_params as jax_save_lstm_params
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.models.presets import sup_v50_config as jax_sup_config
from dorado_tpu_torch.basecall import batch_size
from dorado_tpu_torch.cli.main import main
from dorado_tpu_torch.io import pod5
from dorado_tpu_torch.models.crf_model import params_from_jax
from dorado_tpu_torch.models.presets import config_toml, hac_v43_config, sup_v50_config
from dorado_tpu_torch.models.tx_model import tx_params_from_jax
from dorado_tpu_torch.pipeline import BasecallerPipeline
from tests.test_torch_cli import _records
from tests.test_torch_dtype import (
    JAX_DTYPES,
    MIN_BF16_IDENTITY,
    TORCH_DTYPES,
    _identity,
    one_thread,  # noqa: F401 (the autouse fixture, here too)
)
from tests.test_torch_pipeline import _Collect, _jax_run, _reads
from tests.test_torch_runner import CHUNK, TX_CHUNK, _narrow_hac, jax_params_with_moves
from tests.test_torch_tx_model import jax_tx_params, small_sup

FIXTURE = "tests/data/torch_port/fixture.pod5"
# the fixture's calls at float32: see test_cli_dtype_matches_jax_cli
MIN_F32_FIXTURE_IDENTITY = 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["lstm", "tx"])
def test_run_reads_matches_jax(family, dtype):
    """``run_reads`` against the JAX pipeline's ``run`` on the synthetic reads
    of ``tests/test_torch_pipeline.py`` at the same compute type: the same
    reads in the same order, their calls held as the runner's above."""
    if family == "lstm":
        params = jax_params_with_moves(2)
        jcfg, cfg = _narrow_hac(jax_hac_config()), _narrow_hac(hac_v43_config())
        model, chunk = params_from_jax(params, cfg), CHUNK
    else:
        params = jax_tx_params(3)
        jcfg, cfg = small_sup(jax_sup_config()), small_sup(sup_v50_config())
        model, chunk = tx_params_from_jax(params, cfg), TX_CHUNK
    kw = dict(chunk_size=chunk, batch_size=8, emit_moves=True, decoder="viterbi")
    jp = jax_pipeline_module.BasecallerPipeline(jcfg, params, compute_dtype=JAX_DTYPES[dtype],
                                                **kw)
    ref = _jax_run(jp)
    tp = BasecallerPipeline(cfg, model, device="cpu", compute_dtype=TORCH_DTYPES[dtype], **kw)
    assert tp.runner.compute_dtype == TORCH_DTYPES[dtype]
    out = _Collect()
    stats = tp.run_reads(_reads(pod5), out)
    assert [r.qname for r in out.records] == [r.qname for r in ref]
    assert stats.reads_called == len(ref)
    ref_seqs, out_seqs = [r.seq for r in ref], [r.seq for r in out.records]
    assert sum(map(len, ref_seqs)) > 500
    if dtype == "float32":
        assert out_seqs == ref_seqs
        for a, b in zip(ref, out.records):
            mv = {t.tag: t.value for t in a.tags}["mv"]
            np.testing.assert_array_equal({t.tag: t.value for t in b.tags}["mv"], mv)
    else:
        ratio, _ = _identity(ref_seqs, out_seqs)
        assert ratio >= MIN_BF16_IDENTITY, ratio


@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    """The CLI parity test's narrow hac model directory."""
    model = tmp_path_factory.mktemp("dtype") / "dna_r10.4.1_e8.2_400bps_hac@v4.3.0"
    model.mkdir()
    (model / "config.toml").write_text(config_toml(_narrow_hac(hac_v43_config())))
    jax_save_lstm_params(_narrow_hac(jax_hac_config()), jax_params_with_moves(2), model)
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_dtype_matches_jax_cli(cli_model, tmp_path, dtype):
    """``--dtype`` through both CLIs on the committed fixture (16 reads, read
    splitting on): the same reads; their bases at float32 within
    MIN_F32_FIXTURE_IDENTITY (on the fixture's smooth signal the narrow
    random model calls repeats whose Viterbi near-ties the two packages break
    differently in 2 of 16 reads: ``tests/test_torch_cli.py``; measured
    0.99986), at bf16 within MIN_BF16_IDENTITY (measured 0.994)."""
    common = ["-c", "1200", "-b", "8", "--emit-sam", "--dtype", dtype, "-x", "cpu"]
    ours, theirs = tmp_path / "ours.sam", tmp_path / "theirs.sam"
    assert jax_main(["basecaller", str(cli_model), FIXTURE, *common, "-o", str(theirs)]) == 0
    assert main(["basecaller", str(cli_model), FIXTURE, *common, "-o", str(ours)]) == 0
    _, ref = _records(theirs, "sam")
    _, out = _records(ours, "sam")
    assert sorted(r.qname for r in out) == sorted(r.qname for r in ref) and len(out) >= 16
    by_name = {r.qname: r.seq for r in ref}
    ratio, _ = _identity([by_name[r.qname] for r in out], [r.seq for r in out])
    assert ratio >= (MIN_F32_FIXTURE_IDENTITY if dtype == "float32" else MIN_BF16_IDENTITY), ratio


def test_cli_default_dtype_on_the_cpu_is_float32(cli_model, tmp_path):
    """No ``--dtype`` means float32 on the CPU (the JAX CLI's default off the
    accelerator): the same calls as ``--dtype float32``."""
    args = ["basecaller", str(cli_model), FIXTURE, "-c", "1200", "-b", "8", "--emit-sam",
            "-x", "cpu", "--max-reads", "4"]
    outs = {}
    for name, extra in (("default", []), ("float32", ["--dtype", "float32"])):
        path = tmp_path / f"{name}.sam"
        assert main([*args, *extra, "-o", str(path)]) == 0
        outs[name] = [r.seq for r in _records(path, "sam")[1]]
    assert outs["default"] == outs["float32"]


def test_auto_batch_size_caches_by_dtype(cli_model, tmp_path, monkeypatch):
    """``-b 0``'s sweep is keyed by the compute type too: a float32 result
    is not taken for bf16."""
    from dorado_tpu_torch.models.load import build_model, load_model

    monkeypatch.setenv("DORADO_TPU_TORCH_CACHE_DIR", str(tmp_path))
    config, params = load_model(cli_model)
    model = build_model(config, params)
    for dtype in (torch.float32, torch.bfloat16):
        n = batch_size.auto_batch_size(config, model, 1200, device="cpu", max_batch=64,
                                       compute_dtype=dtype)
        assert n == 64
    import json

    keys = sorted(json.loads((tmp_path / "batch_benchmarks.json").read_text()))
    assert [k.rsplit("|", 1)[1] for k in keys] == ["bfloat16", "float32"]
