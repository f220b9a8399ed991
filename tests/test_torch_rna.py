"""The port's direct-RNA host functions against the JAX package's on seeded
numpy signals and sequences: ``RNAReadSplitter`` (signal split at open-pore
spikes), ``determine_rna_adapter_pos`` (the DNA adapter's end by window
medians), the RNA ``Scaler`` (adapter trim, then each scaling strategy; the
trimmed-sample count), ``find_rna_polya``, and the RNA stand-in config
(``presets.rna004_hac_config``) as both loaders read it."""

import numpy as np
import pytest
import torch

from dorado_tpu.config import ScalingStrategy as JaxStrategy
from dorado_tpu.config import SignalNormalisationParams as JaxNorm
from dorado_tpu.config import StandardisationParams as JaxStd
from dorado_tpu.config import load_model_config as jax_load_config
from dorado_tpu.signal import scaling as jax_scaling
from dorado_tpu.splitter import RNAReadSplitter as JaxRNASplitter
from dorado_tpu.utils import find_rna_polya as jax_find_rna_polya
from dorado_tpu_torch.config import (
    ScalingStrategy,
    SignalNormalisationParams,
    StandardisationParams,
    load_model_config,
)
from dorado_tpu_torch.models.presets import config_toml, hac_v43_config, rna004_hac_config
from dorado_tpu_torch.signal import scaling
from dorado_tpu_torch.splitter import RNAReadSplitter, RNASplitSettings
from dorado_tpu_torch.utils.sequence import find_rna_polya
from tests.torch_rna import rna_signal, rna_signals

LENGTHS = [800, 1500, 5000, 9000, 12000, 20000, 31000, 47000]


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


def _signals(seed):
    rng = np.random.RandomState(seed)
    out = rna_signals(seed, LENGTHS)
    # and reads without an adapter, with two spikes, or spikes in the prefix
    out.append(rna_signal(rng, 15000, adapter=0, spikes=2))
    noisy = rna_signal(rng, 15000, adapter=2500, polya=900)
    noisy[100:160] = 2000  # a spike inside the ignored prefix
    out.append(noisy)
    out.append(np.clip(rng.normal(460, 113, 20000), -32768, 32767).astype(np.int16))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_rna_splitter_matches_jax(seed):
    ours, theirs = RNAReadSplitter(), JaxRNASplitter()
    split = 0
    for sig in _signals(seed):
        got = ours.split(sig)
        assert got == theirs.split(sig)
        assert got[0][0] == 0 and got[-1][1] == len(sig)
        split += len(got) > 1
    assert split >= 3
    tight = RNASplitSettings(pore_thr=1200, pore_cl_dist=500, expect_pore_prefix=100)
    assert RNAReadSplitter(tight).settings.pore_thr == 1200


@pytest.mark.parametrize("seed", range(4))
def test_determine_rna_adapter_pos_matches_jax(seed):
    found = 0
    for sig in _signals(seed):
        pos = scaling.determine_rna_adapter_pos(sig)
        assert pos == jax_scaling.determine_rna_adapter_pos(sig)
        found += pos > 0
    assert found >= len(LENGTHS) // 2


def _norms():
    return [
        (SignalNormalisationParams(strategy=ScalingStrategy.PA,
                                   standardisation=StandardisationParams(
                                       standardise=True, mean=91.88, stdev=22.65)),
         JaxNorm(strategy=JaxStrategy.PA, standardisation=JaxStd(
             standardise=True, mean=91.88, stdev=22.65))),
        (SignalNormalisationParams(strategy=ScalingStrategy.QUANTILE),
         JaxNorm(strategy=JaxStrategy.QUANTILE)),
        (SignalNormalisationParams(strategy=ScalingStrategy.MED_MAD),
         JaxNorm(strategy=JaxStrategy.MED_MAD)),
    ]


@pytest.mark.parametrize("strategy", [0, 1, 2], ids=["pa", "quantile", "med_mad"])
@pytest.mark.parametrize("is_rna", [True, False], ids=["rna", "dna"])
@pytest.mark.parametrize("part", [slice(0, 6), slice(6, None)], ids=["short", "long"])
def test_rna_scaler_matches_jax(strategy, is_rna, part):
    """``scale_read`` returns (scaled signal, trimmed samples, shift/scale)
    in both packages: the adapter trimmed before scaling for RNA."""
    ours, theirs = _norms()[strategy]
    a = scaling.Scaler(ours, is_rna=is_rna)
    b = jax_scaling.Scaler(theirs, is_rna=is_rna)
    trimmed = 0
    for sig in _signals(strategy)[part]:
        kw = dict(read_scale=0.2, read_offset=-3.0, open_pore_level=230.0,
                  flow_cell_product_code="FLO-MIN004RA")
        x, n, r = a.scale_read(sig, **kw)
        y, m, s = b.scale_read(sig, **kw)
        assert n == m and (r.shift, r.scale) == (s.shift, s.scale)
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.float32 and len(x) == len(sig) - n
        trimmed += n > 0
    assert (trimmed > 0) == is_rna


def _polya_sequences(seed):
    rng = np.random.RandomState(seed)
    out = ["", "A", "AAAA", "AAAAA", "CCCCAAAAAAGG", "A" * 300, "ACGT" * 60]
    for _ in range(40):
        body = "".join(rng.choice(list("ACGT"), int(rng.randint(0, 400))))
        tail = "A" * int(rng.randint(0, 30))
        rear = "".join(rng.choice(list("ACGT"), int(rng.randint(0, 250))))
        out.append(body + tail + rear)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_find_rna_polya_matches_jax(seed):
    found = 0
    for seq in _polya_sequences(seed):
        got = find_rna_polya(seq)
        assert got == jax_find_rna_polya(seq)
        found += got < len(seq)
    assert found > 5


def test_rna_stand_in_config_reads_as_rna_in_both_packages(tmp_path):
    """The stand-in keeps hac v4.3's widths and normalisation and takes the
    RNA004 chemistry's sample type and rate; its ``config.toml`` reads back
    as that RNA model in both packages."""
    cfg, hac = rna004_hac_config(), hac_v43_config()
    assert cfg.is_rna_model and not hac.is_rna_model and cfg.sample_rate == 4000
    assert (cfg.lstm_size, cfg.state_len, cfg.stride, [c.size for c in cfg.convs]) == (
        384, 4, 6, [16, 16, 384])
    assert cfg.signal_norm_params == hac.signal_norm_params
    d = tmp_path / cfg.model_name
    d.mkdir()
    (d / "config.toml").write_text(config_toml(cfg))
    for loaded in (load_model_config(d), jax_load_config(d)):
        assert loaded.is_rna_model and loaded.sample_rate == 4000
        assert loaded.model_name == "rna004_130bps_hac@v5.0.0" and loaded.lstm_size == 384
