"""The port's ``PolishPipeline.run`` against the JAX package's on the CPU, on
seeded drafts and reads (``tests/torch_polish.py``) with the same weights
in both: the counts GRU and the read-level LatentSpaceLSTM give the same
polished FASTA, over regions, without filling gaps, with a fill character
and a depth floor, and the same FASTQ qualities but for a bounded share one
phred step apart."""

import re

import jax
import numpy as np
import pytest
import torch

from dorado_tpu.secondary import architectures as jax_arch
from dorado_tpu.secondary import model as jax_model
from dorado_tpu.secondary import polish as jax_polish
from dorado_tpu.secondary.pileup import AlignedRead as JaxAlignedRead
from dorado_tpu_torch.secondary import architectures, model, polish
from tests.torch_polish import jax_gru_params, jax_rl_params, polish_files

# FASTQ qualities: the share of positions whose phred may differ by one step
# (float32 logits some ulp apart, rounded across a .5 boundary); measured 0
# on these inputs for both models
MAX_QUAL_STEP_SHARE = 0.005

_gru_forward = jax.jit(jax_model.gru_forward)
_RL_CFG = dict(lstm_size=16, cnn_size=12, kernel_sizes=(1, 5), use_dwells=True)
_rl_forward = jax.jit(lambda p, x: jax_arch.latent_space_lstm_forward(
    p, x, jax_arch.LatentSpaceLSTMConfig(**_RL_CFG)))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the GRU's and the plain LSTM's many small
    operators crawl at their thread-pool barriers when the test workers
    oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return polish_files(tmp_path_factory.mktemp("polish"))


@pytest.fixture(scope="module")
def gru():
    params = jax_gru_params(np.random.RandomState(7))
    m = model.GRUModel(gru_size=16)
    m.load_state_dict(model.gru_state_dict(params))
    return params, m.eval()


@pytest.fixture(scope="module")
def rl():
    params = jax_rl_params(np.random.RandomState(8), use_dwells=True)
    m = architectures.LatentSpaceLSTM(architectures.LatentSpaceLSTMConfig(**_RL_CFG))
    m.load_state_dict(architectures.latent_space_lstm_state_dict(params))
    return params, m.eval()


def _both(data, ours_kw, theirs_kw, run_kw):
    """(the port's run, the JAX package's run) over the same reads."""
    ours = polish.PolishPipeline(device="cpu", window_len=1000, window_overlap=200, **ours_kw)
    theirs = jax_polish.PolishPipeline(window_len=1000, window_overlap=200, **theirs_kw)
    jax_reads = {k: [JaxAlignedRead(**vars(r)) for r in v] for k, v in data["by_contig"].items()}
    got = ours.run(data["fasta"], data["by_contig"], **run_kw)
    want = theirs.run(data["fasta"], jax_reads, **run_kw)
    assert (ours.stats.windows, ours.stats.contigs) == (theirs.stats.windows,
                                                        theirs.stats.contigs)
    assert ours.stats.forward_s > 0 and ours.stats.features_s > 0
    return got, want


def _qual_steps(got, want):
    """(positions, positions one phred step apart) of two FASTQ runs with
    equal names and sequences; raises on a larger gap."""
    n = diff = 0
    for (gn, (gs, gq)), (wn, (ws, wq)) in zip(got, want, strict=True):
        assert gn == wn and gs == ws and len(gq) == len(wq)
        d = np.abs(np.frombuffer(gq.encode(), np.uint8).astype(int)
                   - np.frombuffer(wq.encode(), np.uint8).astype(int))
        assert d.max(initial=0) <= 1
        n, diff = n + len(d), diff + int((d == 1).sum())
    return n, diff


RUNS = {
    "whole": ({}, {}),
    "qualities": ({}, {"with_quals": True}),
    "regions": ({}, {"regions": {"ctg_a": (450, 1650), "ctg_b": None}}),
    "no_fill_gaps": ({}, {"fill_gaps": False, "regions": {"ctg_a": (0, 1500)}}),
    "fill_char_min_depth": ({"fill_char": "N", "min_depth": 4}, {}),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_counts_pipeline_equals_jax(data, gru, case):
    params, m = gru
    pipe_kw, run_kw = RUNS[case]
    got, want = _both(data, {"model": m, **pipe_kw},
                      {"params": params, "forward": _gru_forward, **pipe_kw}, run_kw)
    if run_kw.get("with_quals"):
        n, diff = _qual_steps(got, want)
        assert diff <= MAX_QUAL_STEP_SHARE * n, (diff, n)
    else:
        assert got == want
    if case == "no_fill_gaps":
        assert all(re.fullmatch(r"ctg_a_\d+ \d+-\d+", name) for name, _ in got), got
    if case == "fill_char_min_depth":
        assert "N" in got[0][1]


@pytest.mark.parametrize("opts", [
    {},
    {"include_haplotags": True, "include_snp_qv": True, "hap_source": "compute",
     "max_reads": 6},
])
def test_read_level_pipeline_equals_jax(data, rl, opts):
    params, m = rl
    kw = {"feature_kind": "read_level", "feature_opts": {"include_dwells": True, **opts}}
    got, want = _both(data, {"model": m, **kw}, {"params": params, "forward": _rl_forward, **kw},
                      {"with_quals": True})
    n, diff = _qual_steps(got, want)
    assert diff <= MAX_QUAL_STEP_SHARE * n, (diff, n)
