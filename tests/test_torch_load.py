"""Model directories: the port's ``load_model`` against the JAX package's on
directories the JAX package writes (a narrow hac and the small sup model),
the port's writer read back by both, and ``config_toml`` round trips."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

from dorado_tpu.config import load_model_config as jax_load_config
from dorado_tpu.models import load as jax_load
from dorado_tpu.models.presets import hac_v43_config as jax_hac_config
from dorado_tpu.models.presets import sup_v50_config as jax_sup_config
from dorado_tpu_torch.config import load_model_config
from dorado_tpu_torch.models import load
from dorado_tpu_torch.models.crf_model import init_lstm_crf_params, params_from_jax
from dorado_tpu_torch.models.presets import (
    config_toml,
    fast_v40_config,
    hac_v43_config,
    lstm_sup_config,
    sup_v50_config,
)
from dorado_tpu_torch.models.tx_model import init_tx_params, tx_params_from_jax
from tests.test_torch_runner import _narrow_hac, jax_params_with_moves
from tests.test_torch_tx_model import jax_tx_params, small_sup


def _plain(obj):
    """A config as nested plain values (enums by value, paths dropped)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name != "model_path"}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _assert_trees_equal(ours, theirs, where="params"):
    if isinstance(theirs, dict):
        assert ours.keys() == theirs.keys(), where
        for k in theirs:
            _assert_trees_equal(ours[k], theirs[k], f"{where}.{k}")
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_trees_equal(a, b, f"{where}[{i}]")
    else:
        assert isinstance(ours, np.ndarray) and ours.shape == theirs.shape, where
        np.testing.assert_array_equal(ours, np.asarray(theirs, ours.dtype), err_msg=where)


def _jax_dir(tmp_path, family):
    if family == "hac":
        cfg, jcfg = _narrow_hac(hac_v43_config()), _narrow_hac(jax_hac_config())
        params, save = jax_params_with_moves(2), jax_load.save_lstm_params
    else:
        cfg, jcfg = small_sup(sup_v50_config()), small_sup(jax_sup_config())
        params, save = jax_tx_params(3), jax_load.save_tx_params
    d = tmp_path / cfg.model_name
    d.mkdir()
    (d / "config.toml").write_text(config_toml(cfg))
    save(jcfg, params, d)
    return d, params


@pytest.mark.parametrize("family", ["hac", "sup"])
def test_load_model_matches_jax(tmp_path, family):
    d, params = _jax_dir(tmp_path, family)
    config, ours = load.load_model(d)
    jconfig, theirs = jax_load.load_model(d)
    assert _plain(config) == _plain(jconfig)
    assert config.model_name == d.name and config.is_tx_model == (family == "sup")
    _assert_trees_equal(ours, theirs)
    _assert_trees_equal(ours, params)
    # build_model makes the model the tests build from the JAX pytree
    model = load.build_model(config, ours)
    want = (tx_params_from_jax if family == "sup" else params_from_jax)(params, config)
    got, ref = model.state_dict(), want.state_dict()
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("family", ["hac", "sup"])
def test_save_model_read_by_both(tmp_path, family):
    """The port's writer (config.toml and weights of a port model) gives a
    directory both loaders read to the same parameters, and a bf16 weight
    file in it reads back bit for bit."""
    gen = torch.Generator().manual_seed(4)
    if family == "hac":
        cfg = _narrow_hac(hac_v43_config())
        model = init_lstm_crf_params(cfg, gen)
    else:
        cfg = small_sup(sup_v50_config())
        model = init_tx_params(cfg, gen)
    d = load.save_model(cfg, model, tmp_path / cfg.model_name)
    config, ours = load.load_model(d)
    _, theirs = jax_load.load_model(d)
    _assert_trees_equal(ours, theirs)
    _assert_trees_equal(ours, load.model_params(model))
    rebuilt = load.build_model(config, ours)
    for k, v in model.state_dict().items():
        assert torch.equal(rebuilt.state_dict()[k], v), k
    # a weight stored in bf16 loads as the float32 it holds exactly
    name = "0.conv.weight.tensor" if family == "hac" else "conv.0.conv.weight.tensor"
    w = model.conv_w[0].detach().bfloat16()
    load.save_tensor_file(d / name, [w])
    _, bf = load.load_model(d)
    np.testing.assert_array_equal(bf["convs"][0]["w"], w.float().permute(2, 1, 0).numpy())


@pytest.mark.parametrize(
    "preset", [hac_v43_config, fast_v40_config, sup_v50_config, lstm_sup_config])
def test_config_toml_round_trip(tmp_path, preset):
    cfg = preset()
    d = tmp_path / cfg.model_name
    d.mkdir()
    (d / "config.toml").write_text(config_toml(cfg))
    ours, theirs = load_model_config(d), jax_load_config(d)
    assert _plain(ours) == _plain(theirs)
    back, want = _plain(ours), _plain(cfg)
    # the loaders' own defaults: a [qscore] table sets the start position to
    # 60 (the pipeline's default for -1); a transformer's top-level CRF
    # fields and batch size are not read from the file
    want["mean_qscore_start_pos"] = 60
    if cfg.is_tx_model:
        for key in ("lstm_size", "out_features", "blank_score", "scale", "basecaller"):
            want[key] = back[key]
    assert back == want


def test_flstm_directory_raises(tmp_path):
    cfg = hac_v43_config()
    d = tmp_path / cfg.model_name
    d.mkdir()
    text = config_toml(cfg).replace('type = "lstm"', 'type = "flstm"\ninner_dim = 128')
    (d / "config.toml").write_text(text)
    assert load_model_config(d).is_flstm_model
    with pytest.raises(ValueError, match="LSTMCRFModel supports conv \\+ LSTM CRF models only"):
        load.load_model(d)
